"""Probes of `benchmarks/micro_pallas_roll.py` and `micro_pallas_roll2.py`:
the frequency conv on the flat roll layout x [C, N], N = T_TILE frames of
F_PAD = 256 lanes whose first 129 are bins.  A tap is a roll of the flat
axis (`pltpu.roll` is `jnp.roll`: out[n] = x[(n - s) mod N]), so the conv is
circular over N and crosses frames: the probes' x is random over all
lanes, pad band included.

  k1  w[0] @ roll(x, 3): one tap, offset -3, every lane an output;
  k2  the K-tap roll conv, output lanes n % 256 >= 129 masked to 0;
  k3  16 chained k2 layers with the same w, relu(acc * mask) * 1e-2 each;
  im2col_stack(depth)  (roll2) depth chained layers of the im2col form,
      wcol [Cout, K * Cin] = w tap-major, relu(conv * mask) each.

w is [K, Cout, Cin] as in the scripts; the kernels take [K, Cin, Cout]
views of it (and of wcol.reshape(Cout, K, Cin)).
"""

from __future__ import annotations

import numpy as np

from fullycnnspeechenhancement_torch.ops.freq_conv import FRAME, VALID
from fullycnnspeechenhancement_torch.probes import Probe

T_TILE, F_PAD, C, K = 64, FRAME, 32, 11
DEPTHS = (1, 4, 8, 16)  # the depths roll2 probes


def inputs(rng: np.random.Generator, T_TILE=T_TILE, C=C, K=K):
    """The scripts' arrays: x and w uniform in [0, 1), wcol in [0, 0.05)."""
    N = T_TILE * F_PAD
    return {
        "x": rng.random((C, N), dtype=np.float32),
        "w": rng.random((K, C, C), dtype=np.float32),
        "wcol": (rng.random((C, K * C)) * 0.05).astype(np.float32),
    }


def _flat(x):
    """[C, N] as the kernel's [B=1, R=1, P=N, C] view."""
    return x.t()[None, None]


def _unflat(y):
    return y[0, 0].t()


def _taps(w):
    """[K, Cout, Cin] -> the kernel's [K, Cin, Cout] view."""
    return w.transpose(1, 2)


def _im2col_taps(x, wcol):
    return x, wcol.reshape(wcol.shape[0], -1, x.shape[0]).permute(1, 2, 0)


k1 = Probe(
    "roll.k1", "4a", "benchmarks/micro_pallas_roll.py:43", ("x", "w"),
    operands=lambda x, w: (_flat(x), _taps(w[:1])),
    options={"lo": 3, "circular": True},
    result=_unflat,
)
k2 = Probe(
    "roll.k2", "4b", "benchmarks/micro_pallas_roll.py:55", ("x", "w"),
    operands=lambda x, w: (_flat(x), _taps(w)),
    options={"circular": True, "period": F_PAD, "valid": VALID},
    result=_unflat,
)
k3 = Probe(
    "roll.k3", "4c", "benchmarks/micro_pallas_roll.py:73", ("x", "w"),
    operands=lambda x, w: (x, _taps(w)),
    options={"depth": 16, "frame": F_PAD, "valid": VALID, "scale": 1e-2},
    kernel="freq_conv_stack",
)


def im2col_stack(depth: int) -> Probe:
    return Probe(
        f"roll.im2col_stack({depth})", "4d", "benchmarks/micro_pallas_roll2.py:46", ("x", "wcol"),
        operands=_im2col_taps,
        options={"depth": depth, "frame": F_PAD, "valid": VALID},
        kernel="freq_conv_stack",
    )


PROBES = (k1, k2, k3) + tuple(im2col_stack(d) for d in DEPTHS)
