"""Sharded dispatch on ``torch.distributed``: the Monte-Carlo sweep over a
mesh of ranks (`parallel.sweep`)."""
