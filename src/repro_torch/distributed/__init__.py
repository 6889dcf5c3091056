"""Logical-axis sharding of the port: the rule tables and the spec
resolution of `repro.distributed.sharding`, read by one process per rank
(`launch.mesh`)."""
