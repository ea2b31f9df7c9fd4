"""Training runtime: step builders, microbatching, gradient compression,
fault tolerance (port of ``repro/runtime``; the sharding rules and the
tensor-parallel plan come with tensor parallelism, ROADMAP Queue 1)."""
