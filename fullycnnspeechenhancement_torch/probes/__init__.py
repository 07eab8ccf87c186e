"""The kernel probes: counterparts of the repo-root
`benchmarks/micro_pallas_*.py` scripts, with their probe names kept.

Those scripts time one (1, K) frequency conv, its Pallas formulations, and
chains of it kept on chip; here every probe is one launch of a kernel of
`ops/freq_conv.py` (`freq_conv`, or `freq_conv_stack` for the chains) on
the probe's own inputs, viewed with no copy:

  conv.py  <- micro_pallas_conv.py          vA, vB, vC
  roll.py  <- micro_pallas_roll.py, roll2   k1, k2, k3, im2col_stack(depth)
  min.py   <- micro_pallas_min.py, min2     k1..k4, min2_k3, min2_k5, min2_k6

Each module draws its inputs with numpy (`inputs(rng, **shape)`, the
script's shapes by default) and lists its probes in `PROBES`.
`python -m fullycnnspeechenhancement_torch.probes` runs them all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


def _same(y: torch.Tensor) -> torch.Tensor:
    return y


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: `operands` turns the probe's arrays (named by `args`, in
    the Pallas kernel's order) into the kernel's x and w views; the kernel
    runs with `options`; `result` views its output in the layout the
    Pallas probe returns."""

    name: str  # <module>.<function> of this package
    row: str  # row of PERF.md's kernel table
    replaces: str  # file:line of the Pallas kernel body
    args: Tuple[str, ...]
    operands: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    options: Dict[str, object] = dataclasses.field(default_factory=dict)
    kernel: str = "freq_conv"  # or "freq_conv_stack"
    result: Callable[[torch.Tensor], torch.Tensor] = _same

    def __call__(self, *args: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The probe's output: one kernel launch on CUDA tensors, or its
        plain version (always with `plain`, and on CPU tensors)."""
        from fullycnnspeechenhancement_torch.ops import freq_conv as fc

        fn = {
            ("freq_conv", False): fc.freq_conv,
            ("freq_conv", True): fc.freq_conv_plain,
            ("freq_conv_stack", False): fc.freq_conv_stack,
            ("freq_conv_stack", True): fc.freq_conv_stack_plain,
        }[self.kernel, plain]
        x, w = self.operands(*args)
        return self.result(fn(x, w, **self.options))


def all_probes():
    """[(module, probe)] in the order of PERF.md's kernel table."""
    from fullycnnspeechenhancement_torch.probes import conv, min, roll

    return [(m, p) for m in (conv, roll, min) for p in m.PROBES]
