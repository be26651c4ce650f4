"""Deterministic random generator for lattice-instance generation.

Plays the role of the reference's ``RandGen``/``RandGenInt``
(fplll/nr/nr_rand.inl:11-80), which wraps GMP's default
randstate. We use Python's Mersenne Twister instead; sequences are
deterministic under a fixed seed but are NOT bit-compatible with GMP's
(cross-tool parity is pinned through checked-in fixtures instead, see
tests/).
"""

from __future__ import annotations

import random
import time


class RandGen:
    """Process-global deterministic RNG (mirrors RandGen's static API)."""

    _rng: random.Random | None = None

    @classmethod
    def init(cls) -> None:
        cls._rng = random.Random(0)

    @classmethod
    def init_with_seed(cls, seed: int) -> None:
        cls._rng = random.Random(seed)

    @classmethod
    def init_with_time(cls) -> None:
        cls._rng = random.Random(int(time.time()))

    @classmethod
    def get_initialized(cls) -> bool:
        return cls._rng is not None

    @classmethod
    def get(cls) -> random.Random:
        if cls._rng is None:
            cls.init()
        return cls._rng  # type: ignore[return-value]

    # -- draws mirroring Z_NR::randb / randm ------------------------------
    @classmethod
    def randb(cls, bits: int) -> int:
        """Uniform integer in [0, 2^bits)."""
        if bits <= 0:
            return 0
        return cls.get().getrandbits(bits)

    @classmethod
    def randm(cls, m: int) -> int:
        """Uniform integer in [0, m)."""
        if m <= 0:
            return 0
        return cls.get().randrange(m)


class RandGenInt:
    """Small-int RNG used by BKZ rerandomization (nr_rand.inl:50-80)."""

    _rng: random.Random | None = None

    @classmethod
    def init(cls, seed: int | None = None) -> None:
        cls._rng = random.Random(seed if seed is not None else int(time.time()))

    @classmethod
    def get(cls) -> int:
        if cls._rng is None:
            cls.init(0)
        return cls._rng.randrange(1 << 31)  # type: ignore[union-attr]

    @classmethod
    def get_bit(cls) -> int:
        """Returns -1 or 1 with equal probability."""
        return 1 if (cls.get() & 1) else -1
