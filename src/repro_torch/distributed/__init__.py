"""Distributed training pieces of the port. Only the value-level fp8
gradient compression is here so far; the mesh (sharding rules, ZeRO specs,
the compressed all-reduce) comes with ROADMAP item A9b."""
