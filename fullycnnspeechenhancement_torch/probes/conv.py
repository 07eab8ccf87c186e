"""Probes of `benchmarks/micro_pallas_conv.py`: one TF SAME (1, K) frequency
conv in three formulations, at T frames of F bins, C -> D channels.

  vA  x [1, T, F, C] (*) w [K, C, D]: the sum of K per-tap dots;
  vB  the same with the weights as one im2col matrix w2 [K * C, D],
      tap-major (w2.reshape(K, C, D) is w);
  vC  xt [1, T, C, F] (channels before frequency) (*) w [K, C, D],
      CIRCULAR along F: out[t, d, f] = sum_j sum_c w[j, c, d] *
      xt[t, c, (f + j - (K - 1) // 2) mod F].  The Pallas probe writes this
      as `pltpu.roll(xx, -shift, 2)`, a negative shift that the TPU roll
      refuses; the roll it means is `jnp.roll`.
"""

from __future__ import annotations

import numpy as np

from fullycnnspeechenhancement_torch.probes import Probe

T, F, C, D, K = 64, 129, 25, 25, 11


def inputs(rng: np.random.Generator, T=T, F=F, C=C, D=D, K=K):
    """The script's arrays, uniform in [0, 1) like its np.random.rand."""
    return {
        "x": rng.random((1, T, F, C), dtype=np.float32),
        "w": rng.random((K, C, D), dtype=np.float32),
        "w2": rng.random((K * C, D), dtype=np.float32),
        "xt": rng.random((1, T, C, F), dtype=np.float32),
    }


vA = Probe(
    "conv.vA", "3a", "benchmarks/micro_pallas_conv.py:54", ("x", "w"),
    operands=lambda x, w: (x, w),
)
vB = Probe(
    "conv.vB", "3b", "benchmarks/micro_pallas_conv.py:80", ("x", "w2"),
    operands=lambda x, w2: (x, w2.reshape(w2.shape[0] // x.shape[3], x.shape[3], w2.shape[1])),
)
vC = Probe(
    "conv.vC", "3c", "benchmarks/micro_pallas_conv.py:108", ("xt", "w"),
    operands=lambda xt, w: (xt.permute(0, 1, 3, 2), w),
    options={"circular": True},
    result=lambda y: y.permute(0, 1, 3, 2),
)

PROBES = (vA, vB, vC)
