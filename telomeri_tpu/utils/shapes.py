"""Shape bucketing: bound the number of distinct compiled shapes across datasets.

Every dataset produces different edge/walk counts; padding each to its exact
multiple-of-8 length makes XLA compile a fresh program per dataset. Padding instead
to a small geometric family of lengths
(granularity = a power-of-two multiple of the required divisor, ~n/8) caps the
waste at ~12.5% while giving at most ~8 distinct shapes per power of two — so
compiled programs (and the persistent jax compilation cache) are reused across
datasets of similar scale. Results are padding-invariant by construction
(SURVEY.md §5 item 3; enforced by tests/test_walk.py + test_dist.py).
"""

from __future__ import annotations


def bucket_len(n: int, multiple: int = 1) -> int:
    """Smallest padded length >= n from the bucket family; always a multiple of
    `multiple`; 0 stays 0 (empty sections skip their scan entirely)."""
    if n <= 0:
        return 0
    g = max(int(multiple), 1)
    while g * 16 < n:         # granularity in [n/16, n/8) -> waste < 12.5%
        g *= 2
    return -(-n // g) * g
