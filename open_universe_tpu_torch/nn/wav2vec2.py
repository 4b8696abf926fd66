"""A wav2vec 2.0 CTC model in PyTorch: the frozen phoneme recogniser of the
phoneme losses (``losses/phoneme_loss.py``) and of the LPS metric
(``metrics/lps.py``).  The JAX package runs ``transformers``'
``FlaxWav2Vec2ForCTC`` for the losses and its torch ``Wav2Vec2ForCTC`` for
LPS; the port owns this copy, so that it needs neither package.

It covers the architecture the Flax model supports, in eval mode (no
dropout, no masking, no attention mask):

    feature encoder   len(conv_dim) x [Conv1d (valid), LayerNorm over
                      channels, exact GELU]            (feat_extract_norm="layer")
    projection        LayerNorm, Linear to hidden_size
    positional conv   grouped Conv1d with weight norm (one norm per tap),
                      "same" padding (one frame dropped for an even kernel),
                      GELU, added to the hidden states
    encoder layers    h += attn(LN(h)); h += FFN(final_LN(h))  (stable LN)
    encoder LN, lm_head

Parameters carry ``transformers``' torch names
(``wav2vec2.feature_extractor.conv_layers.{i}.conv.weight``, ...,
``wav2vec2.encoder.pos_conv_embed.conv.weight_g``/``weight_v``,
``lm_head.weight``), so ``load_pretrained`` reads a Hugging Face checkpoint
directory (``config.json`` and ``pytorch_model.bin`` or
``model.safetensors``) without remapping.  Nothing is ever downloaded: a
hub id resolves only to a snapshot already in the local Hugging Face cache.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_CHECKPOINT = "facebook/wav2vec2-lv-60-espeak-cv-ft"
WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


@dataclass
class Wav2Vec2Config:
    """The architecture keys of a ``transformers`` ``Wav2Vec2Config``
    (``config.json``), with its defaults; other keys are ignored."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    feat_extract_activation: str = "gelu"
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    vocab_size: int = 32
    pad_token_id: int = 0
    add_adapter: bool = False

    def __post_init__(self):
        self.conv_dim, self.conv_kernel, self.conv_stride = (
            tuple(self.conv_dim), tuple(self.conv_kernel), tuple(self.conv_stride))
        # what FlaxWav2Vec2ForCTC supports (modeling_flax_wav2vec2.py:386, 954)
        if self.feat_extract_norm != "layer" or not self.do_stable_layer_norm:
            raise NotImplementedError(
                "only feat_extract_norm='layer' with do_stable_layer_norm=True is "
                f"supported (got {self.feat_extract_norm!r}, {self.do_stable_layer_norm})")
        if self.add_adapter:
            raise NotImplementedError("wav2vec2 adapters (add_adapter=True) are not supported")
        for act in (self.hidden_act, self.feat_extract_activation):
            if act != "gelu":
                raise NotImplementedError(f"activation {act!r}: only 'gelu' is supported")
        if not len(self.conv_dim) == len(self.conv_kernel) == len(self.conv_stride):
            raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must be a multiple of num_attention_heads")

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# The published architecture of facebook/wav2vec2-lv-60-espeak-cv-ft: the
# large wav2vec 2.0 (Baevski et al., arXiv:2006.11477) fine-tuned for CTC on
# espeak phonemes (the checkpoint's config.json on the Hugging Face hub).
LV60_ESPEAK = Wav2Vec2Config(
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
    feat_extract_norm="layer", do_stable_layer_norm=True, conv_dim=(512,) * 7,
    conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_bias=True,
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5,
    vocab_size=392, pad_token_id=0)


class _ConvLayer(nn.Module):
    """Conv1d (valid), LayerNorm over channels, GELU; (B, C, T) -> (B, C', T')."""

    def __init__(self, cfg: Wav2Vec2Config, i: int):
        super().__init__()
        cin = cfg.conv_dim[i - 1] if i else 1
        self.conv = nn.Conv1d(cin, cfg.conv_dim[i], cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[i], eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = self.layer_norm(self.conv(x).transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(_ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, x):  # (B, T) -> (B, T', C)
        x = x[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class _WeightNormConv1d(nn.Module):
    """The positional conv: a grouped Conv1d whose weight is
    ``weight_v * weight_g / ||weight_v||``, the norm taken over (out, in/g),
    one per tap (``transformers``' ``weight_norm(dim=2)``; Flax
    ``FlaxConvWithWeightNorm``); padded by k // 2 on both sides."""

    def __init__(self, channels: int, k: int, groups: int):
        super().__init__()
        self.groups, self.pad = groups, k // 2
        v = torch.randn(channels, channels // groups, k) * (2.0 / (k * channels // groups)) ** 0.5
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))
        self.bias = nn.Parameter(torch.zeros(channels))

    def weight(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.weight_v, dim=(0, 1), keepdim=True)
        return self.weight_v * (self.weight_g / norm)

    def forward(self, x):  # (B, C, T)
        return F.conv1d(x, self.weight(), self.bias, padding=self.pad, groups=self.groups)


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = _WeightNormConv1d(cfg.hidden_size, k, cfg.num_conv_pos_embedding_groups)
        self.remove = 1 if k % 2 == 0 else 0

    def forward(self, x):  # (B, T, C) -> (B, T, C)
        y = self.conv(x.transpose(1, 2))
        if self.remove:
            y = y[:, :, :-self.remove]
        return F.gelu(y).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x):  # (B, T, D)
        b, t, d = x.shape

        def split(y):
            return y.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        # softmax(q k^T / sqrt(head_dim)) v, no mask, no dropout
        o = F.scaled_dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                           split(self.v_proj(x)))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, d))


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """Stable layer norm: h += attn(LN(h)); h += FFN(final_LN(h))."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.attention = _Attention(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h):
        h = h + self.attention(self.layer_norm(h))
        return h + self.feed_forward(self.final_layer_norm(h))


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h):
        h = h + self.pos_conv_embed(h)
        for layer in self.layers:
            h = layer(h)
        return self.layer_norm(h)


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, x):  # (B, T) -> (B, T', hidden)
        return self.encoder(self.feature_projection(self.feature_extractor(x)))


class Wav2Vec2ForCTC(nn.Module):
    """(B, T) waveform (normalised by the caller) -> (B, T', vocab) CTC logits."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.wav2vec2 = Wav2Vec2Model(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.wav2vec2(input_values))


# ---------------------------------------------------------------- loading
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file: a little-endian u64 header
    length, a JSON header ({name: {dtype, shape, data_offsets}}), then the
    raw little-endian bytes of every tensor."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        numel = (end - start) // dtype.itemsize
        flat = (torch.frombuffer(buf, dtype=dtype, count=numel, offset=start) if numel
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _hub_caches():
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(Path(os.environ["HF_HUB_CACHE"]))
    if os.environ.get("HF_HOME"):
        roots.append(Path(os.environ["HF_HOME"]) / "hub")
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    return roots


def _is_checkpoint(d: Path) -> bool:
    return (d / "config.json").is_file() and any((d / w).is_file() for w in WEIGHT_FILES)


def resolve_checkpoint(checkpoint: Union[str, Path] = DEFAULT_CHECKPOINT) -> Path:
    """The local directory of a checkpoint: the path itself, or for a hub id
    (``org/name``) its snapshot in the local Hugging Face cache (the one
    ``refs/main`` names, else any), as ``from_pretrained`` resolves it
    offline.  Raises ``FileNotFoundError`` naming the files it needs; never
    downloads."""
    path = Path(checkpoint).expanduser()
    if _is_checkpoint(path):
        return path
    tried = [str(path)]
    for root in _hub_caches():
        repo = root / ("models--" + str(checkpoint).replace("/", "--"))
        snaps = repo / "snapshots"
        tried.append(str(snaps))
        ref = repo / "refs" / "main"
        cands = [snaps / ref.read_text().strip()] if ref.is_file() else []
        cands += sorted(snaps.glob("*")) if snaps.is_dir() else []
        for cand in cands:
            if _is_checkpoint(cand):
                return cand
    raise FileNotFoundError(
        f"no local wav2vec2 checkpoint for {str(checkpoint)!r}: it needs a directory with "
        f"config.json and {' or '.join(WEIGHT_FILES)} (and vocab.json for lps), given as "
        f"the path or as a snapshot of the Hugging Face cache; looked in {tried}. "
        "Nothing is downloaded.")


def port_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``transformers`` ``Wav2Vec2ForCTC`` state dict in this model's
    names: newer torch's weight-norm parametrisation names
    (``.parametrizations.weight.original0``/``original1``) become
    ``weight_g``/``weight_v``; ``masked_spec_embed`` (used only for
    masking in training) is dropped; floating tensors become float32."""
    out = {}
    for k, v in sd.items():
        if k.endswith("masked_spec_embed"):
            continue
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        out[k] = v.float() if v.is_floating_point() else v
    return out


def load_pretrained(checkpoint: Union[str, Path] = DEFAULT_CHECKPOINT) -> Wav2Vec2ForCTC:
    """A ``Wav2Vec2ForCTC`` from a local checkpoint directory or a cached hub
    id (``resolve_checkpoint``): ``config.json``, then ``model.safetensors``
    (read in-house) or ``pytorch_model.bin`` (``torch.load(weights_only=True)``),
    loaded strictly, on the CPU, in eval mode, frozen."""
    path = resolve_checkpoint(checkpoint)
    cfg = Wav2Vec2Config.from_dict(json.loads((path / "config.json").read_text()))
    if (path / "model.safetensors").is_file():
        sd = read_safetensors(path / "model.safetensors")
    else:
        sd = torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)
    with torch.device("meta"):
        model = Wav2Vec2ForCTC(cfg)
    model.load_state_dict(port_state_dict(sd), strict=True, assign=True)
    return model.eval().requires_grad_(False)
