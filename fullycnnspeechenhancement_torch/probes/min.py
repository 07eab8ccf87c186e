"""Probes of `benchmarks/micro_pallas_min.py` and `micro_pallas_min2.py`:
the pieces of the frequency conv one at a time, on x [1, T, F, C].

  k1, k2   the pointwise channel dot x @ w (K = 1; rank-3 and reshaped 2-D
           forms of one function);
  k3       pad by 1 and slice [1:1+F] (an identity shift), then the dot;
  k4       (x shifted -3 + x shifted +3, zero-padded) @ w: two taps 6 bins
           apart, both with w (a K = 7 conv whose other taps are zero);
  min2_k3  k3 again with min2's wc (the script's retry);
  min2_k5  the TF SAME K-tap conv as a fori_loop over dynamic slices;
  min2_k6  the same with the taps unrolled.

k4's two taps are one launch with K = 2, dilation 6, lo = 3 and w repeated
by a stride-0 view.
"""

from __future__ import annotations

import numpy as np

from fullycnnspeechenhancement_torch.probes import Probe

T, F, C, D, K = 64, 129, 25, 25, 11


def inputs(rng: np.random.Generator, T=T, F=F, C=C, D=D, K=K):
    """The scripts' arrays, uniform in [0, 1): min's x and w [C, D], and
    min2's w [K, C, D] (here `wk`) and wc [C, D]."""
    return {
        "x": rng.random((1, T, F, C), dtype=np.float32),
        "w": rng.random((C, D), dtype=np.float32),
        "wk": rng.random((K, C, D), dtype=np.float32),
        "wc": rng.random((C, D), dtype=np.float32),
    }


def _dot(x, w):
    return x, w[None]


k1 = Probe("min.k1", "5a", "benchmarks/micro_pallas_min.py:26", ("x", "w"), operands=_dot)
k2 = Probe("min.k2", "5a", "benchmarks/micro_pallas_min.py:32", ("x", "w"), operands=_dot)
k3 = Probe("min.k3", "5b", "benchmarks/micro_pallas_min.py:38", ("x", "w"), operands=_dot)
k4 = Probe(
    "min.k4", "5c", "benchmarks/micro_pallas_min.py:46", ("x", "w"),
    operands=lambda x, w: (x, w[None].expand(2, *w.shape)),
    options={"lo": 3, "dilation": 6},
)
min2_k3 = Probe("min.min2_k3", "5d", "benchmarks/micro_pallas_min2.py:25", ("x", "wc"), operands=_dot)
min2_k5 = Probe(
    "min.min2_k5", "5e", "benchmarks/micro_pallas_min2.py:33", ("x", "wk"),
    operands=lambda x, wk: (x, wk),
)
min2_k6 = Probe(
    "min.min2_k6", "5f", "benchmarks/micro_pallas_min2.py:43", ("x", "wk"),
    operands=lambda x, wk: (x, wk),
)

PROBES = (k1, k2, k3, k4, min2_k3, min2_k5, min2_k6)
