"""UCP Lookahead greedy kernel (port of the JAX package's
repro.kernels.lookahead_greedy)."""
from repro_torch.kernels.lookahead_greedy.ops import (
    LAUNCHES,
    lookahead_greedy,
    lookahead_greedy_plain,
)

__all__ = ["LAUNCHES", "lookahead_greedy", "lookahead_greedy_plain"]
