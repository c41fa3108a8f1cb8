"""BPE tokenizer and the host-side sampler (xorshift* coin stream)."""

from .bpe import Tokenizer  # noqa: F401
from .sampler import Sampler, xorshift_random_f32  # noqa: F401
