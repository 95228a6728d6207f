"""Sharded dispatch on ``torch.distributed``: the Monte-Carlo sweep over a
mesh of ranks (`parallel.sweep`) and the LM stack's sharding rules
(`parallel.sharding`)."""
