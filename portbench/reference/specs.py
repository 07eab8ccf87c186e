"""Frozen layer specs of the R-CED / CR-CED family (Park & Lee,
arXiv:1609.07132; the reference implementation's `model_utils/model.py`).

A layer is (name, out_channels, (kernel_time, kernel_freq), use_norm,
use_act, skip_from, add_from):

  * `skip_from`: the named layer's output is added after BN, before ReLU
    (the V1/V2 decoders);
  * `add_from`: the named layer's output is added after the ReLU (V3's
    block-output residual).

Every conv is stride 1 with TF SAME padding ((k - 1) // 2 before, k // 2
after) on [B, C, T, F] with F = 129 bins and one input channel.  These
tuples are the benchmark's own copy: the roofline counts (`work.py`) and
the plain reference (`model.py`) read them, never the program's specs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class Layer(NamedTuple):
    name: str
    out_ch: int
    kernel: Tuple[int, int]
    use_norm: bool = True
    use_act: bool = True
    skip_from: Optional[str] = None
    add_from: Optional[str] = None


def _v1():
    return (
        Layer("encode_1", 12, (8, 13)),
        Layer("encode_2", 16, (1, 11)),
        Layer("encode_3", 20, (1, 9)),
        Layer("encode_4", 24, (1, 7)),
        # the reference scopes V1's fifth encoder layer "encode_8"
        Layer("encode_8", 32, (1, 7)),
        Layer("decode_1", 24, (1, 7), skip_from="encode_4"),
        Layer("decode_2", 20, (1, 9), skip_from="encode_3"),
        Layer("decode_3", 16, (1, 11), skip_from="encode_2"),
        Layer("decode_4", 12, (1, 13), skip_from="encode_1"),
        Layer("decode_5", 1, (1, 129), use_norm=False, use_act=False),
    )


def _v2():
    enc_ch = (10, 12, 14, 15, 19, 21, 23, 25)
    enc_k = ((8, 11), (1, 7), (1, 5), (1, 5), (1, 5), (1, 5), (1, 7), (1, 11))
    dec_ch = (23, 21, 19, 15, 14, 12, 10)
    dec_k = ((1, 7), (1, 5), (1, 5), (1, 5), (1, 5), (1, 7), (1, 11))
    enc = [Layer(f"encode_{i + 1}", c, k) for i, (c, k) in enumerate(zip(enc_ch, enc_k))]
    dec = [
        Layer(f"decode_{i + 1}", c, k, skip_from=f"encode_{7 - i}")
        for i, (c, k) in enumerate(zip(dec_ch, dec_k))
    ]
    return tuple(enc + dec + [Layer("decode_8", 1, (1, 129), use_norm=False, use_act=False)])


def _v3():
    def block(name, first, add_from=None):
        return [
            Layer(f"{name}_encode_1", 18, first),
            Layer(f"{name}_encode_2", 30, (1, 5)),
            Layer(f"{name}_decode", 8, (1, 9), add_from=add_from),
        ]

    return tuple(
        block("CE1", (8, 9))
        + block("CE2", (1, 9))
        + block("CE3", (1, 9))
        + block("CD1", (1, 9), add_from="CE2_decode")
        + block("CD2", (1, 9), add_from="CE1_decode")
        + [Layer("decode_final", 1, (1, 129), use_norm=False, use_act=False)]
    )


# keyed by the reference's `[model] net_work` names
MODELS = {"FullyCNN": _v1(), "FullyCNNV2": _v2(), "FullyCNNV3": _v3()}

F_BINS = 129


def in_channels(layers):
    """[input channels of each layer]: 1 for the first."""
    out, ch = [], 1
    for lay in layers:
        out.append(ch)
        ch = lay.out_ch
    return out


def param_count(layers) -> int:
    total = 0
    for lay, cin in zip(layers, in_channels(layers)):
        kh, kw = lay.kernel
        total += kh * kw * cin * lay.out_ch + lay.out_ch + (2 * lay.out_ch if lay.use_norm else 0)
    return total
