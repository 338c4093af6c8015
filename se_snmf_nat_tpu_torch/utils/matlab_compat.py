"""MATLAB-compatibility numerics: the port's own copy of the NumPy half of
the reference package's ``utils.matlab_compat`` (generators, rounding, the
int16 write and the wavwrite quantisation), plus the int16 write on tensors
(``matlab_int16_write_torch``) and the wavwrite quantisation of int16 PCM
as a table (``matlab_wavwrite_table``).

The reference calls ``rand('seed', p.random_seed)`` before every NMF solve
(sparse_nmf.m:112-114) and then draws ``h = rand(r, n)``.  ``rand('seed', s)``
selects MATLAB's legacy *V4* uniform generator: the Park–Miller / Lehmer
"minimal standard" multiplicative congruential generator

    x_{k+1} = 16807 * x_k  mod  (2^31 - 1),     u_k = x_k / (2^31 - 1)

(C. Moler, *Numerical Computing with MATLAB*, ch. 9).  Because the seed is
reset to the same value before every solve, the H initialization is a fixed,
reproducible matrix — we reproduce it exactly so the pipeline can match
the reference's waveforms.

MATLAB fills matrices column-major; ``rand(m, n)`` therefore consumes m*n
draws down the columns.
"""

from __future__ import annotations

import numpy as np
import torch

_M31 = 2**31 - 1  # 2147483647
_A = 16807


class MatlabV4Rand:
    """Stateful generator equivalent to MATLAB's legacy rand('seed', s)."""

    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, s: int) -> None:
        s = int(s) % _M31
        if s == 0:
            # MATLAB maps a zero seed to a nonzero internal state; the
            # reference never uses seed 0 (seed>0 guard, sparse_nmf.m:112),
            # so any fixed nonzero value is fine here.
            s = 1
        self._state = s

    def rand(self, m: int, n: int | None = None) -> np.ndarray:
        """rand(m) / rand(m, n) with MATLAB column-major fill order."""
        if n is None:
            n = m
        return self._draw(m * n).reshape((n, m)).T  # column-major fill

    def _draw(self, count: int) -> np.ndarray:
        """Vectorized: draw k is a^k * s0 mod M31.  The powers table doubles
        in log2(count) numpy ops; products stay < 2^62 in uint64."""
        if count == 0:
            return np.empty(0, dtype=np.float64)
        mod = np.uint64(_M31)
        pows = np.ones(1, dtype=np.uint64)
        while len(pows) < count:
            step = np.uint64(pow(_A, len(pows), _M31))
            pows = np.concatenate([pows, (pows * step) % mod])
        pows = pows[:count]
        first = np.uint64((_A * self._state) % _M31)
        vals = (pows * first) % mod
        self._state = int(vals[-1])
        return vals.astype(np.float64) / _M31


def matlab_v4_rand_matrix(m: int, n: int, seed: int = 1) -> np.ndarray:
    """One-shot: rand('seed', seed); rand(m, n). Used for NMF H init."""
    gen = MatlabV4Rand(seed)
    return gen.rand(m, n)


class MatlabTwister:
    """MATLAB's default mt19937ar stream (rng(seed,'twister')).

    MATLAB seeds with init_genrand(seed) and draws doubles with
    genrand_res53 (53-bit: (a*2^26 + b) / 2^53).  NumPy's RandomState seeds
    via init_by_array, so its stream differs — hence this implementation.
    A freshly started MATLAB begins at seed 0; init_buff.m's un-seeded
    ``rand(R_d, m)`` / ``rand(R_a, m_a)`` state inits draw from it.
    """

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 0):
        self.mt = np.zeros(self.N, dtype=np.uint64)
        self.mti = self.N + 1
        self._init_genrand(seed)

    def _init_genrand(self, s: int) -> None:
        mt = self.mt
        mt[0] = s & 0xFFFFFFFF
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.mti = self.N

    def _genrand_int32(self) -> int:
        mt = self.mt
        if self.mti >= self.N:
            for i in range(self.N):
                y = (int(mt[i]) & self.UPPER) | (int(mt[(i + 1) % self.N]) & self.LOWER)
                mt[i] = int(mt[(i + self.M) % self.N]) ^ (y >> 1) ^ \
                    (self.MATRIX_A if y & 1 else 0)
            self.mti = 0
        y = int(mt[self.mti])
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def rand(self, m: int, n: int | None = None) -> np.ndarray:
        """MATLAB rand(m[, n]) — genrand_res53, column-major fill."""
        if n is None:
            n = m
        out = np.empty(m * n, dtype=np.float64)
        for i in range(m * n):
            a = self._genrand_int32() >> 5
            b = self._genrand_int32() >> 6
            out[i] = (a * 67108864.0 + b) / 9007199254740992.0
        return out.reshape((n, m)).T


def matlab_round(x: np.ndarray) -> np.ndarray:
    """MATLAB round(): half away from zero (np.round is half-to-even)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def matlab_int16_write(x: np.ndarray) -> np.ndarray:
    """MATLAB fwrite(fid, x, 'int16') semantics: round half-away, saturate."""
    y = matlab_round(np.asarray(x, dtype=np.float64))
    return np.clip(y, -32768, 32767).astype(np.int16)


def matlab_wavwrite_quantize(x: np.ndarray) -> np.ndarray:
    """MATLAB wavwrite(x, fs, 16, ...) 16-bit quantization: round(x*32768),
    saturated.  Note the asymmetric scale (32768, not 32767)."""
    y = matlab_round(np.asarray(x, dtype=np.float64) * 32768.0)
    return np.clip(y, -32768, 32767).astype(np.int16)


def matlab_wavwrite_table() -> np.ndarray:
    """``matlab_wavwrite_quantize(v / 32767.0)`` for every int16 ``v``, at
    index ``v`` read as a negative index reads (``v % 65536``): the wavwrite
    requantisation of int16 PCM as one gather, bit for bit."""
    v = np.arange(65536, dtype=np.uint16).view(np.int16)
    return matlab_wavwrite_quantize(v / 32767.0)


def matlab_int16_write_torch(y: torch.Tensor) -> torch.Tensor:
    """MATLAB ``fwrite(fid, y, 'int16')`` on the device: round half away
    from zero, saturate, int16.  ``y + 0.5`` and ``floor`` are exact over the
    int16 range in f32, so this equals the host chain bit for bit."""
    r = torch.sign(y) * torch.floor(torch.abs(y) + 0.5)
    return torch.clamp(r, -32768, 32767).to(torch.int16)
