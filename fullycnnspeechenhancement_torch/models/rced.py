"""The R-CED / CR-CED model family as declarative layer specs.

Counterpart of `fullycnnspeechenhancement_tpu/models/rced.py`.  Topologies
from the reference's `model_utils/model.py` (V1 :6-29, V2 :32-61, V3
:64-96): each model is a linear chain of conv blocks with named taps for
skip connections.  Two skip styles exist in the reference:

  * `skip_from` on a conv layer: added after BN, before ReLU -- V1/V2
    decoders;
  * `add_from` on a conv layer: residual add *after* the layer's full
    conv+BN+ReLU output -- V3's block-output skip.

Layer names replicate the reference's variable scopes exactly, including
the V1 quirk where the 5th encoder layer is scoped "encode_8", so TF
checkpoints map 1:1 by name.  Parameter counts: V1 32,765 / V2 32,192 /
V3 32,653.

Parameters are a dict keyed by layer name, each {"w" OIHW, "b", "gamma",
"beta"}; BN state is {"mean", "var"} per normalised layer.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from fullycnnspeechenhancement_torch.models.blocks import (
    conv_bn_relu_apply,
    conv_bn_relu_init,
)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    out_ch: int
    kernel: Tuple[int, int]
    use_norm: bool = True
    use_act: bool = True
    skip_from: Optional[str] = None  # pre-ReLU skip (V1/V2 style)
    add_from: Optional[str] = None  # post-ReLU residual add (V3 style)


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    layers: Tuple[ConvSpec, ...]

    def init(self, generator: torch.Generator, in_ch: int = 1, device="cpu"):
        """(params, state) dicts keyed by layer name, drawn from `generator`
        (a CPU `torch.Generator`) and moved to `device`."""
        params, state = {}, {}
        ch = in_ch
        for spec in self.layers:
            p, s = conv_bn_relu_init(generator, ch, spec.out_ch, spec.kernel, spec.use_norm)
            params[spec.name] = {k: v.to(device) for k, v in p.items()}
            if s:
                state[spec.name] = {k: v.to(device) for k, v in s.items()}
            ch = spec.out_ch
        return params, state

    def apply(
        self,
        params,
        state,
        x: torch.Tensor,
        *,
        is_training: bool = False,
        frame_mask: Optional[torch.Tensor] = None,
    ):
        """NHWC [B, T, F, 1] -> [B, T, F, 1].  Returns (y, new_state) like
        the JAX package's `apply`.

        Activations run in the dtype of `x` (the caller casts it to
        `compute_dtype`).  `frame_mask` ([B, T], or [1, T] for the
        row-identical batch-max mask) restricts training-mode BN's batch
        statistics to masked frames (see blocks.conv_bn_relu_apply)."""
        h = x.permute(0, 3, 1, 2)  # NCHW inside
        taps, new_state = {}, {}
        for spec in self.layers:
            h, s = conv_bn_relu_apply(
                params[spec.name],
                state.get(spec.name, {}),
                h,
                is_training=is_training,
                use_norm=spec.use_norm,
                use_act=spec.use_act,
                skip_input=taps[spec.skip_from] if spec.skip_from else None,
                frame_mask=frame_mask,
            )
            if spec.add_from is not None:
                h = h + taps[spec.add_from]
            if spec.name in state:
                new_state[spec.name] = s
            taps[spec.name] = h
        return h.permute(0, 2, 3, 1), new_state

    def param_count(self, in_ch: int = 1) -> int:
        total, ch = 0, in_ch
        for spec in self.layers:
            kh, kw = spec.kernel
            total += kh * kw * ch * spec.out_ch + spec.out_ch  # w + b
            if spec.use_norm:
                total += 2 * spec.out_ch  # gamma + beta
            ch = spec.out_ch
        return total


def _v1() -> ModelDef:
    enc = [
        ConvSpec("encode_1", 12, (8, 13)),
        ConvSpec("encode_2", 16, (1, 11)),
        ConvSpec("encode_3", 20, (1, 9)),
        ConvSpec("encode_4", 24, (1, 7)),
        # Reference quirk: V1's 5th encoder layer is scoped "encode_8"
        # (model.py:15) -- preserved for checkpoint-name parity.
        ConvSpec("encode_8", 32, (1, 7)),
    ]
    dec = [
        ConvSpec("decode_1", 24, (1, 7), skip_from="encode_4"),
        ConvSpec("decode_2", 20, (1, 9), skip_from="encode_3"),
        ConvSpec("decode_3", 16, (1, 11), skip_from="encode_2"),
        ConvSpec("decode_4", 12, (1, 13), skip_from="encode_1"),
        ConvSpec("decode_5", 1, (1, 129), use_norm=False, use_act=False),
    ]
    return ModelDef("FullyCNN", tuple(enc + dec))


def _v2() -> ModelDef:
    enc_ch = [10, 12, 14, 15, 19, 21, 23, 25]
    enc_k = [(8, 11), (1, 7), (1, 5), (1, 5), (1, 5), (1, 5), (1, 7), (1, 11)]
    enc = [
        ConvSpec(f"encode_{i + 1}", c, k)
        for i, (c, k) in enumerate(zip(enc_ch, enc_k))
    ]
    dec_ch = [23, 21, 19, 15, 14, 12, 10]
    dec_k = [(1, 7), (1, 5), (1, 5), (1, 5), (1, 5), (1, 7), (1, 11)]
    dec = [
        ConvSpec(f"decode_{i + 1}", c, k, skip_from=f"encode_{7 - i}")
        for i, (c, k) in enumerate(zip(dec_ch, dec_k))
    ]
    dec.append(ConvSpec("decode_8", 1, (1, 129), use_norm=False, use_act=False))
    return ModelDef("FullyCNNV2", tuple(enc + dec))


def _v3() -> ModelDef:
    def rced_block(name, first_kernel, add_from=None):
        return [
            ConvSpec(f"{name}_encode_1", 18, first_kernel),
            ConvSpec(f"{name}_encode_2", 30, (1, 5)),
            ConvSpec(f"{name}_decode", 8, (1, 9), add_from=add_from),
        ]

    layers = (
        rced_block("CE1", (8, 9))
        + rced_block("CE2", (1, 9))
        + rced_block("CE3", (1, 9))
        # V3 decoder blocks add the encoder *block outputs* post-activation
        # (model.py:75-77,87-88).
        + rced_block("CD1", (1, 9), add_from="CE2_decode")
        + rced_block("CD2", (1, 9), add_from="CE1_decode")
        + [ConvSpec("decode_final", 1, (1, 129), use_norm=False, use_act=False)]
    )
    return ModelDef("FullyCNNV3", tuple(layers))


V1 = _v1()
V2 = _v2()
V3 = _v3()

MODEL_REGISTRY = {
    "FullyCNN": V1,
    "FullyCNNV2": V2,
    "FullyCNNV3": V3,
}


def get_model(net_work: str) -> ModelDef:
    """Resolve a reference `net_work` name; unknown names fall back to V1
    (matching trainer.py:165-171's default-with-warning behaviour)."""
    if net_work not in MODEL_REGISTRY:
        logging.getLogger(__name__).warning(
            "net_work=%s unknown; using FullyCNN (V1)", net_work
        )
        return V1
    return MODEL_REGISTRY[net_work]
