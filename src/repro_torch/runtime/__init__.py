"""Runtime: step builders, microbatching, gradient compression, fault
tolerance and tensor-parallel serving (``tp``) (port of ``repro/runtime``;
the sharding rules of ``sharding.py`` / ``actsharding.py`` are ROADMAP
Queue 1 item 8)."""
