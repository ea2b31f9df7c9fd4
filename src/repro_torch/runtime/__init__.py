"""Runtime: step builders, microbatching, gradient compression, fault
tolerance, tensor-parallel serving (``tp``) and the GSPMD sharding rules
the dry-run reads (``sharding``) (port of ``repro/runtime``; the
reference's opt-in activation constraints, ``actsharding.py``, are ROADMAP
Queue 1 item 8's rest)."""
