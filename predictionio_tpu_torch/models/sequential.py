"""Sequential recommender: SASRec-style causal transformer, served on the card.

Counterpart of ``predictionio_tpu/models/sequential.py``. A user's recent
items become a right-aligned id sequence (item index + 1; 0 pads); a causal
transformer reads it, and the logits of the last position against every
item embedding rank the next item.

* :class:`SASRecConfig` has every field of the JAX config.
* :class:`SASRecModel` holds the host numpy params, ``item_map`` and
  ``config`` (what a blob pickles) and serves :meth:`SASRecModel.recommend`
  through a :class:`SASRecNet`, the weights on the device, built once per
  model (at deploy, by the template's ``load_serializable_model``). The JAX
  package copies its host params into every jitted call instead.
* :func:`_forward` applies the JAX package's gate: at a flash-eligible
  length on a CUDA device (``ops.flash_attention.use_flash_default``) every
  layer's attention runs the hand-written flash kernel, else the dense
  ``parallel.ring.full_attention``. Serving pads to ``max_len``, so a
  ``max_len`` of 256 or more (a multiple of 128) serves through the kernel.
* :func:`sasrec_params_from_jax` carries a JAX param tree across;
  :func:`init_params` draws params on numpy with the JAX scales.

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP item
that brings them: the mixture-of-experts FFN (``n_experts > 0``) and
``train_sasrec`` (ROADMAP §1 item 3, the training slice with the two
backward kernels), ``seq_parallel`` (item 10) and ``checkpoint_dir``
(item 7).
"""

from __future__ import annotations

import dataclasses
import threading
from functools import partial
from typing import Optional, Union

import numpy as np
import torch

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops.flash_attention import flash_attention, use_flash_default
from predictionio_tpu_torch.parallel.ring import full_attention

PAD = 0  # item ids are shifted by +1; 0 is the padding token
LAYER_KEYS = ("wqkv", "wo", "ln1", "ln2", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    d_model: int = 32
    n_layers: int = 2
    n_heads: int = 2
    max_len: int = 32
    epochs: int = 20
    batch_size: int = 128
    lr: float = 1e-2
    seed: int = 0
    # Mixture-of-experts FFN (0 = dense): not ported yet (ROADMAP §1 item 3)
    n_experts: int = 0
    expert_capacity: float = 1.25
    moe_aux_weight: float = 0.01
    # ring attention over a `model` mesh axis: not ported yet (item 10)
    seq_parallel: bool = False
    # mid-training checkpoint/resume: not ported yet (item 7)
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 10


def _require_dense_ffn(cfg: SASRecConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "the mixture-of-experts FFN (n_experts > 0) is not ported yet "
            "(ROADMAP §1 item 3)"
        )


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def init_params(
    generator_or_seed: Union[np.random.Generator, int], cfg: SASRecConfig, n_items: int
) -> dict:
    """Host params drawn on numpy with the scales of the JAX
    ``_init_params``: embeddings N(0, 0.02²), projections N(0, 1/fan_in),
    layer-norm gains 1."""
    _require_dense_ffn(cfg)
    rng = (
        generator_or_seed
        if isinstance(generator_or_seed, np.random.Generator)
        else np.random.default_rng(generator_or_seed)
    )
    d = cfg.d_model

    def normal(shape, scale):
        return _f32(rng.standard_normal(shape) * scale)

    params = {
        "emb": normal((n_items + 1, d), 0.02),
        "pos": normal((cfg.max_len, d), 0.02),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wqkv": normal((d, 3 * d), d**-0.5),
            "wo": normal((d, d), d**-0.5),
            "ln1": np.ones(d, np.float32),
            "ln2": np.ones(d, np.float32),
            "w1": normal((d, 4 * d), d**-0.5),
            "w2": normal((4 * d, d), (4 * d) ** -0.5),
        })
    return params


def sasrec_params_from_jax(params: dict) -> dict:
    """The JAX param tree, as numpy arrays, → the port's host params.

    The port keeps the JAX layouts (``emb`` (n_items + 1, d), ``pos``
    (max_len, d), per layer ``wqkv`` (d, 3d), ``wo`` (d, d), ``ln1``/``ln2``
    (d,), ``w1`` (d, 4d), ``w2`` (4d, d), applied as ``x @ w``), so this
    checks the tree and copies it as contiguous float32.
    """
    layers = []
    for layer in params["layers"]:
        if "router" in layer:
            raise NotImplementedError(
                "the mixture-of-experts FFN (n_experts > 0) is not ported yet "
                "(ROADMAP §1 item 3)"
            )
        layers.append({k: _f32(layer[k]) for k in LAYER_KEYS})
    out = {"emb": _f32(params["emb"]), "pos": _f32(params["pos"]), "layers": layers}
    d = out["emb"].shape[1]
    for layer in layers:
        shapes = {k: v.shape for k, v in layer.items()}
        want = {"wqkv": (d, 3 * d), "wo": (d, d), "ln1": (d,), "ln2": (d,),
                "w1": (d, 4 * d), "w2": (4 * d, d)}
        if shapes != want:
            raise ValueError(f"layer shapes {shapes} do not match d_model {d}: {want}")
    return out


def _use_flash(t: int, device) -> bool:
    """Delegates to the shared gate beside the kernel; kept as a module
    symbol so tests can monkeypatch the policy, as the JAX tests do."""
    return use_flash_default(t, device)


def _layer_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The JAX formula: eps 1e-6 inside the rsqrt, a gain and no bias."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g


def _block_stack(params: dict, seq: torch.Tensor, cfg: SASRecConfig, pos, attention):
    """The transformer body: seq (B, T) → hidden (B, T, D).

    ``pos`` is the positional table for these positions; ``attention``
    maps head-split (B, H, T, h) q/k/v, each contiguous, to the attention
    output (dense or the flash kernel, chosen by the caller). Pad rows are
    zeroed after every layer. The JAX function also returns the MoE
    auxiliary loss, which a dense FFN does not have.
    """
    _require_dense_ffn(cfg)
    seq = seq.long()
    x = params["emb"][seq] + pos[None, :, :]
    pad_mask = (seq == PAD)[:, :, None]
    h = cfg.d_model // cfg.n_heads

    def heads(z):  # (B, T, D) → (B, H, T, h)
        return z.reshape(*z.shape[:-1], cfg.n_heads, h).transpose(-3, -2).contiguous()

    for layer in params["layers"]:
        y = _layer_norm(x, layer["ln1"])
        q, k, v = (y @ layer["wqkv"]).split(cfg.d_model, dim=-1)
        a = attention(heads(q), heads(k), heads(v))
        a = a.transpose(-3, -2).reshape(y.shape)
        x = x + a @ layer["wo"]
        y = _layer_norm(x, layer["ln2"])
        x = x + torch.relu(y @ layer["w1"]) @ layer["w2"]
        x = x.masked_fill(pad_mask, 0.0)
    return x


def _forward(params: dict, seq: torch.Tensor, cfg: SASRecConfig, allow_flash: bool = False):
    """seq (B, T) → hidden (B, T, D). ``allow_flash`` sends every layer's
    attention through the flash kernel where the gate allows it."""
    if allow_flash and _use_flash(seq.shape[-1], seq.device):
        attention = partial(flash_attention, causal=True)
    else:
        attention = partial(full_attention, causal=True)
    return _block_stack(params, seq, cfg, params["pos"], attention)


def _predict_logits(params: dict, seq: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """(B, T) → (B, n_items): the last position against every item."""
    hidden = _forward(params, seq, cfg, allow_flash=True)
    return hidden[:, -1, :] @ params["emb"][1:].T


class SASRecNet(torch.nn.Module):
    """The weights of one model on one device, placed once."""

    def __init__(self, params: dict, cfg: SASRecConfig, device):
        super().__init__()
        _require_dense_ffn(cfg)
        self.cfg = cfg

        def put(a):
            return torch.nn.Parameter(torch.tensor(_f32(a), device=device), requires_grad=False)

        self.emb = put(params["emb"])
        self.pos = put(params["pos"])
        self.layers = torch.nn.ModuleList(
            torch.nn.ParameterDict({k: put(layer[k]) for k in LAYER_KEYS})
            for layer in params["layers"]
        )

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def tree(self) -> dict:
        """The weights in the JAX param tree's shape."""
        return {
            "emb": self.emb,
            "pos": self.pos,
            "layers": [{k: layer[k] for k in LAYER_KEYS} for layer in self.layers],
        }

    @torch.no_grad()
    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        """seq (B, T) item ids (+1, 0 pads) → logits (B, n_items)."""
        return _predict_logits(self.tree(), seq.to(self.device), self.cfg)


@dataclasses.dataclass
class SASRecModel:
    params: dict  # host numpy tree (see sasrec_params_from_jax)
    item_map: BiMap
    config: SASRecConfig

    def __post_init__(self):
        self._net: Optional[SASRecNet] = None
        self._lock = threading.Lock()

    # the blob pickles the numpy params only, so it loads on any device
    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k not in ("_net", "_lock")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__post_init__()

    def bind(self, device) -> SASRecNet:
        """Place the weights on ``device`` (once; a later call for another
        device replaces them)."""
        with self._lock:
            if self._net is None or self._net.device != torch.device(device):
                self._net = SASRecNet(self.params, self.config, device)
            return self._net

    @property
    def net(self) -> SASRecNet:
        """The bound weights; a model never bound is placed on the default
        device (CUDA, which raises without a card)."""
        if self._net is None:
            from predictionio_tpu_torch.device import DeviceContext

            self.bind(DeviceContext.create().device)
        return self._net

    def recommend(
        self, history: list[str], num: int, exclude_history: bool = True
    ) -> tuple[list[str], np.ndarray]:
        idx = [self.item_map[i] for i in history if i in self.item_map]
        if not idx:
            return [], np.array([])
        cfg = self.config
        seq = np.zeros(cfg.max_len, np.int64)
        tail = idx[-cfg.max_len:]
        seq[-len(tail):] = np.asarray(tail) + 1
        logits = self.net(torch.from_numpy(seq[None, :]))[0].cpu().numpy()
        top, scores = host_top_items(logits, idx if exclude_history else [], num)
        inv = self.item_map.inverse
        return [inv[int(i)] for i in top], scores


def host_top_items(logits: np.ndarray, exclude, num: int) -> tuple[np.ndarray, np.ndarray]:
    """The host step of ``recommend`` (``models/sequential.py:94-99``): the
    excluded items set to -1e30, the top ``num`` by ``argpartition`` and
    ``argsort``, the excluded sentinels dropped. Returns (indices, scores)."""
    logits = logits.copy()
    if len(exclude):
        logits[np.asarray(exclude)] = -1e30
    k = min(num, len(logits))
    top = np.argpartition(-logits, k - 1)[:k]
    top = top[np.argsort(-logits[top])]
    top = top[logits[top] > -1e29]  # drop excluded-item sentinels
    return top, logits[top]


def train_sasrec(ctx, interactions, config: Optional[SASRecConfig] = None) -> SASRecModel:
    """Not ported yet: SASRec training comes with the next slice."""
    cfg = config or SASRecConfig()
    if cfg.seq_parallel:
        raise NotImplementedError(
            "seq_parallel (ring attention across devices) is not ported yet "
            "(ROADMAP §1 item 10)"
        )
    if cfg.checkpoint_dir:
        raise NotImplementedError(
            "checkpoint_dir (mid-training checkpoints) is not ported yet "
            "(ROADMAP §1 item 7)"
        )
    _require_dense_ffn(cfg)
    raise NotImplementedError(
        "SASRec training is not ported yet (ROADMAP §1 item 3: the flash "
        "backward kernels and the training loop); train with the JAX package "
        "and carry the params across with sasrec_params_from_jax"
    )
