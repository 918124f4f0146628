"""R-exact random number streams (base R's RNG.c / snorm.c / sexp.c /
rgamma.c algorithms), for the one reference code path that pins a seed:
the Monte-Carlo KL dispersion-prior branch (R/core.R:1157-1191,
set.seed(2)).

Implements, faithfully to R's C sources:

- Mersenne-Twister with R's ``set.seed`` scrambling (RNG_Init's
  69069*seed+1 LCG warmup + fill, MT_FixupSeeds' mti=624) and
  ``unif_rand``'s fixup into the open interval;
- ``norm_rand`` via the default INVERSION method (two uniforms glued at
  2^27 resolution, AS 241 qnorm);
- ``exp_rand`` (Ahrens-Dieter 1972 algorithm using log(2)^k/k! tables);
- ``rgamma`` via GS (a < 1) and GD (a >= 1) (Ahrens & Dieter 1974/1982),
  and ``rchisq(df) = rgamma(df/2, 2)``.

A copy of the JAX package's numpy module (deseq2_tpu/rng_r.py), which is
validated against the classic published R values for set.seed(1)/
set.seed(42)/set.seed(123) streams (tests/test_rng_r.py).  rgamma's GD
constants are transcribed from the published algorithm, so the gamma
stream is exact by construction rather than golden-tested.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["RRandomState"]

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_I2_32M1 = 2.328306437080797e-10  # 1/(2^32 - 1)

# exp_rand's q[k] = sum_{j<=k+1} log(2)^j / j!
_EXP_Q = []
_t = 0.0
_l2 = math.log(2.0)
_term = 1.0
for _k in range(1, 17):
    _term *= _l2 / _k
    _t += _term
    _EXP_Q.append(_t)


def _qnorm(p):
    """AS 241 (Wichura 1988) inverse normal CDF — bit-compatible with
    R's qnorm5(p, 0, 1, TRUE, FALSE)."""
    q = p - 0.5
    if abs(q) <= 0.425:
        r = 0.180625 - q * q
        num = (((((((r * 2509.0809287301226727 + 33430.575583588128105)
                    * r + 67265.770927008700853) * r
                   + 45921.953931549871457) * r + 13731.693765509461125)
                 * r + 1971.5909503065514427) * r + 133.14166789178437745)
               * r + 3.387132872796366608)
        den = (((((((r * 5226.495278852545703 + 28729.085735721942674)
                    * r + 39307.89580009271061) * r
                   + 21213.794301586595867) * r + 5394.1960214247511077)
                 * r + 687.1870074920579083) * r + 42.313330701600911252)
               * r + 1.0)
        return q * num / den
    r = p if q < 0 else 1.0 - p
    r = math.sqrt(-math.log(r))
    if r <= 5.0:
        r -= 1.6
        num = (((((((r * 7.7454501427834140764e-4
                     + 0.0227238449892691845833) * r
                    + 0.24178072517745061177) * r
                   + 1.27045825245236838258) * r
                  + 3.64784832476320460504) * r + 5.7694972214606914055)
                * r + 4.6303378461565452959) * r + 1.42343711074968357734)
        den = (((((((r * 1.05075007164441684324e-9
                     + 5.475938084995344946e-4) * r
                    + 0.0151986665636164571966) * r
                   + 0.14810397642748007459) * r
                  + 0.68976733498510000455) * r + 1.6763848301838038494)
                * r + 2.05319162663775882187) * r + 1.0)
    else:
        r -= 5.0
        num = (((((((r * 2.01033439929228813265e-7
                     + 2.71155556874348757815e-5) * r
                    + 0.0012426609473880784386) * r
                   + 0.026532189526576123093) * r
                  + 0.29656057182850489123) * r + 1.7848265399172913358)
                * r + 5.4637849111641143699) * r + 6.6579046435011037772)
        den = (((((((r * 2.04426310338993978564e-15
                     + 1.4215117583164458887e-7) * r
                    + 1.8463183175100546818e-5) * r
                   + 7.868691311456132591e-4) * r
                  + 0.0148753612908506148525) * r
                 + 0.13692988092273580531) * r + 0.59983220655588793769)
               * r + 1.0)
    val = num / den
    return -val if q < 0 else val


class RRandomState:
    """R's Mersenne-Twister stream after ``set.seed(seed)``."""

    def __init__(self, seed):
        s = np.uint32(seed)
        # RNG_Init: 50 LCG warmup steps, then fill mti + 624 state words
        with np.errstate(over="ignore"):
            for _ in range(50):
                s = np.uint32(s * np.uint32(69069) + np.uint32(1))
            filled = np.empty(_N + 1, dtype=np.uint32)
            for j in range(_N + 1):
                s = np.uint32(s * np.uint32(69069) + np.uint32(1))
                filled[j] = s
        self.mt = filled[1:].copy()
        self.mti = _N  # MT_FixupSeeds(initial=TRUE): dummy[0] = 624
        self._buf = np.empty(0)
        self._pos = 0
        # rgamma GD statics (aa/aaa caches persist across calls in R)
        self._gd_a = -1.0
        self._gd = {}

    # -- raw MT ----------------------------------------------------------

    def _regenerate(self):
        """One MT19937 state twist + tempering, vectorized.

        The scalar loop's read-after-write dependencies are the second
        phase's mt[k+M-N] and the last word's mt[0]/mt[M-1] (already
        new).  For k >= 2(N-M) the second phase reads words it wrote
        itself (k+M-N >= N-M), so it runs in two slices, each reading
        only finished words.  (deseq2_tpu/rng_r.py runs it in one slice,
        which reads new[N-M:M-1] before they are written: its streams
        after the first 2(N-M) = 454 words of each twist depend on
        uninitialised memory.)"""
        old = self.mt.astype(np.uint64)
        n = _N
        mag01 = np.array([0, _MATRIX_A], dtype=np.uint64)
        new = np.empty(n, dtype=np.uint64)
        y_old = (old[:-1] & _UPPER_MASK) | (old[1:] & _LOWER_MASK)  # k<N-1
        f_old = (y_old >> 1) ^ mag01[y_old & 1]
        new[:n - _M] = old[_M:] ^ f_old[:n - _M]
        half = 2 * (n - _M)
        new[n - _M:half] = new[:n - _M] ^ f_old[n - _M:half]
        new[half:n - 1] = new[n - _M:_M - 1] ^ f_old[half:]
        y_last = (old[n - 1] & _UPPER_MASK) | (new[0] & _LOWER_MASK)
        new[n - 1] = new[_M - 1] ^ (y_last >> 1) ^ mag01[y_last & 1]
        self.mt = new.astype(np.uint32)
        # tempering (vectorized)
        y = new
        y = y ^ (y >> 11)
        y = (y ^ ((y << 7) & 0x9D2C5680)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & 0xEFC60000)) & 0xFFFFFFFF
        y = y ^ (y >> 18)
        self._buf = y.astype(np.float64) * 2.3283064365386963e-10
        self._pos = 0
        self.mti = 0

    def unif_rand(self):
        if self.mti >= _N or self._pos >= len(self._buf):
            self._regenerate()
        x = self._buf[self._pos]
        self._pos += 1
        self.mti += 1
        # fixup into the open interval (RNG.c fixup)
        if x <= 0.0:
            return 0.5 * _I2_32M1
        if 1.0 - x <= 0.0:
            return 1.0 - 0.5 * _I2_32M1
        return x

    def runif(self, n):
        return np.array([self.unif_rand() for _ in range(n)])

    # -- norm_rand (INVERSION) ------------------------------------------

    def norm_rand(self):
        big = 134217728.0  # 2^27
        u1 = self.unif_rand()
        u1 = int(big * u1) + self.unif_rand()
        return _qnorm(u1 / big)

    def rnorm(self, n, mean=0.0, sd=1.0):
        """R's rnorm: sd == 0 returns mean WITHOUT consuming the stream
        (rnorm.c's early return)."""
        if sd == 0.0:
            return np.full(n, mean)
        return np.array([mean + sd * self.norm_rand() for _ in range(n)])

    # -- exp_rand --------------------------------------------------------

    def exp_rand(self):
        a = 0.0
        u = self.unif_rand()
        while u <= 0.0 or u >= 1.0:
            u = self.unif_rand()
        while True:
            u += u
            if u > 1.0:
                break
            a += _EXP_Q[0]
        u -= 1.0
        if u <= _EXP_Q[0]:
            return a + u
        i = 0
        ustar = self.unif_rand()
        umin = ustar
        while True:
            ustar = self.unif_rand()
            if ustar < umin:
                umin = ustar
            i += 1
            if u <= _EXP_Q[i]:
                break
        return a + umin * _EXP_Q[0]

    # -- rgamma (GS for a<1, GD for a>=1) -------------------------------

    def rgamma(self, a, scale=1.0):
        exp_m1 = 0.36787944117144232
        if a < 1.0:  # GS
            e = 1.0 + exp_m1 * a
            while True:
                p = e * self.unif_rand()
                if p >= 1.0:
                    x = -math.log((e - p) / a)
                    if self.exp_rand() >= (1.0 - a) * math.log(x):
                        return scale * x
                else:
                    x = math.exp(math.log(p) / a)
                    if self.exp_rand() >= x:
                        return scale * x
        # GD
        sqrt32 = 5.656854249492380195206754896838
        q1, q2, q3 = 0.04166669, 0.02083148, 0.00801191
        q4, q5, q6, q7 = 0.00144121, -7.388e-5, 2.4511e-4, 2.424e-4
        a1, a2, a3, a4 = 0.3333333, -0.250003, 0.2000062, -0.1662921
        a5, a6, a7 = 0.1423657, -0.1367177, 0.1233795
        if a != self._gd_a:
            self._gd_a = a
            s2 = a - 0.5
            s = math.sqrt(s2)
            d = sqrt32 - s * 12.0
            r = 1.0 / a
            q0 = ((((((q7 * r + q6) * r + q5) * r + q4) * r + q3) * r
                   + q2) * r + q1) * r
            if a <= 3.686:
                b = 0.463 + s + 0.178 * s2
                si = 1.235
                c = 0.195 / s - 0.079 + 0.16 * s
            elif a <= 13.022:
                b = 1.654 + 0.0076 * s2
                si = 1.68 / s + 0.275
                c = 0.062 / s + 0.024
            else:
                b = 1.77
                si = 0.75
                c = 0.1515 / s
            self._gd = dict(s2=s2, s=s, d=d, q0=q0, b=b, si=si, c=c)
        g = self._gd
        s2, s, d = g["s2"], g["s"], g["d"]
        q0, b, si, c = g["q0"], g["b"], g["si"], g["c"]

        t = self.norm_rand()
        x = s + 0.5 * t
        ret_val = x * x
        if t >= 0.0:
            return scale * ret_val
        u = self.unif_rand()
        if d * u <= t * t * t:
            return scale * ret_val

        def q_of(t_):
            v = t_ / (s + s)
            if abs(v) <= 0.25:
                return q0 + 0.5 * t_ * t_ * ((((((a7 * v + a6) * v + a5)
                                                * v + a4) * v + a3) * v
                                              + a2) * v + a1) * v
            return q0 - s * t_ + 0.25 * t_ * t_ \
                + (s2 + s2) * math.log(1.0 + v)

        if x > 0.0:
            q = q_of(t)
            if math.log(1.0 - u) <= q:
                return scale * ret_val
        while True:
            e = self.exp_rand()
            u = self.unif_rand()
            u = u + u - 1.0
            t = b - si * e if u < 0.0 else b + si * e
            if t >= -0.71874483771719:
                q = q_of(t)
                if q > 0.0:
                    w = math.expm1(q) if q <= 0.5 else math.exp(q) - 1.0
                    if c * abs(u) <= w * math.exp(e - 0.5 * t * t):
                        break
        x = s + 0.5 * t
        return scale * x * x

    def rchisq(self, n, df):
        """R's rchisq: rgamma(df/2, 2) per draw."""
        return np.array([self.rgamma(df / 2.0, 2.0) for _ in range(n)])
