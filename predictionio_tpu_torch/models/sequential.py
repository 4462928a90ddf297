"""Sequential recommender: SASRec-style causal transformer, trained and
served on the card.

Counterpart of ``predictionio_tpu/models/sequential.py``. A user's recent
items become a right-aligned id sequence (item index + 1; 0 pads); a causal
transformer reads it, and the logits of the last position against every
item embedding rank the next item. Training predicts every next item of a
sequence (causal cross-entropy).

* :class:`SASRecConfig` has every field of the JAX config.
* :class:`SASRecModel` holds the host numpy params, ``item_map`` and
  ``config`` (what a blob pickles) and serves :meth:`SASRecModel.recommend`
  through a :class:`SASRecNet`, the weights on the device, built once per
  model (at deploy, by the template's ``load_serializable_model``). The JAX
  package copies its host params into every jitted call instead.
* :func:`_forward` applies the JAX package's gate: at a flash-eligible
  length on a CUDA device (``ops.flash_attention.use_flash_default``) every
  layer's attention runs the hand-written flash kernels (the forward, and
  in training the two backward kernels through the autograd Function),
  else the dense ``parallel.ring.full_attention``. Serving pads to
  ``max_len`` and training reads ``max_len`` inputs, so a ``max_len`` of
  256 or more (a multiple of 128) runs the kernels.
* ``n_experts > 0`` makes each FFN a Switch-style top-1 mixture of experts
  (:func:`_moe_ffn`), whose load-balancing loss joins the training loss.
* :func:`train_sasrec` trains on one device: ``build_sequences``, the
  ``>= 2 events`` filter, the JAX package's numpy batch sampler, one Adam
  step per epoch. With ``checkpoint_dir`` the params and Adam state are
  saved every ``checkpoint_interval`` epochs (``core/checkpoint.py``) and a
  rerun resumes from the last step whose fingerprint matches.
* :func:`sasrec_params_from_jax` carries a JAX param tree across;
  :func:`init_params` draws params on numpy with the JAX scales.

* ``seq_parallel`` (:func:`_build_sp_loss`) trains with the batch split
  over the mesh's ``data`` axis and time over its ``model`` axis: the
  one-token shift is done on the whole sequence first, each block takes its
  slice of ``pos``, and each layer's attention is the dense ring
  (``parallel/ring._ring_attention_block``) over the ``model`` placements,
  as in the JAX package; the loss is the ``psum`` of the blocks' masked
  sums. A mesh of repeated placements (``["cpu"] * 2``, ``[cuda:0] * 2``)
  runs it on one device.

* Under ``pio launch`` (a :class:`~predictionio_tpu_torch.parallel.ingest.
  ShardedInteractions`) training is data parallel across processes: each
  process builds its own users' sequences, draws ``batch / n_hosts`` rows
  from them (its own seeded stream), computes the masked sums of its rows,
  divides by the GLOBAL count of valid targets and all-reduces the
  gradients (:func:`dp_train_step`), so each step is the one-process step
  on the concatenated batch. ``seq_parallel`` and experts raise there, as
  in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from functools import partial
from typing import Optional, Union

import numpy as np
import torch

from predictionio_tpu_torch.core import persistence as _persistence
from predictionio_tpu_torch.data.batch import Interactions
from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.ops.flash_attention import flash_attention, use_flash_default
from predictionio_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, pad_to_multiple, psum
from predictionio_tpu_torch.parallel.ring import _ring_attention_block, full_attention

PAD = 0  # item ids are shifted by +1; 0 is the padding token
LAYER_KEYS = ("wqkv", "wo", "ln1", "ln2", "w1", "w2")

logger = logging.getLogger(__name__)


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
    # Mixture-of-experts FFN (0 = dense): Switch-style top-1 routing with a
    # per-row capacity of expert_capacity · T / n_experts slots
    n_experts: int = 0
    expert_capacity: float = 1.25
    moe_aux_weight: float = 0.01
    # ring attention over the mesh's `model` axis (sequence parallelism)
    seq_parallel: bool = False
    # mid-training checkpoint/resume: params + Adam state saved every
    # checkpoint_interval epochs under checkpoint_dir; a restart resumes
    # from the latest matching step
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 10


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.float32)


def init_params(
    generator_or_seed: Union[np.random.Generator, int], cfg: SASRecConfig, n_items: int
) -> dict:
    """Host params drawn on numpy with the scales of the JAX
    ``_init_params``: embeddings N(0, 0.02²), projections N(0, 1/fan_in),
    layer-norm gains 1; with experts, ``router`` (d, E), ``w1`` (E, d, 4d)
    and ``w2`` (E, 4d, d)."""
    rng = (
        generator_or_seed
        if isinstance(generator_or_seed, np.random.Generator)
        else np.random.default_rng(generator_or_seed)
    )
    d = cfg.d_model

    def normal(shape, scale):
        return _f32(rng.standard_normal(shape) * scale)

    e = cfg.n_experts
    lead = (e,) if e else ()
    params = {
        "emb": normal((n_items + 1, d), 0.02),
        "pos": normal((cfg.max_len, d), 0.02),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "wqkv": normal((d, 3 * d), d**-0.5),
            "wo": normal((d, d), d**-0.5),
            "ln1": np.ones(d, np.float32),
            "ln2": np.ones(d, np.float32),
            "w1": normal((*lead, d, 4 * d), d**-0.5),
            "w2": normal((*lead, 4 * d, d), (4 * d) ** -0.5),
        }
        if e:
            layer["router"] = normal((d, e), d**-0.5)
        params["layers"].append(layer)
    return params


_draw_params = init_params  # train_sasrec's own ``init_params`` argument shadows the name


def sasrec_params_from_jax(params: dict) -> dict:
    """The JAX param tree, as numpy arrays, → the port's host params.

    The port keeps the JAX layouts (``emb`` (n_items + 1, d), ``pos``
    (max_len, d), per layer ``wqkv`` (d, 3d), ``wo`` (d, d), ``ln1``/``ln2``
    (d,), ``w1`` (d, 4d), ``w2`` (4d, d), applied as ``x @ w``; a mixture of
    E experts adds ``router`` (d, E) and leads ``w1``/``w2`` with E), so
    this checks the tree and copies it as contiguous float32.
    """
    layers = []
    for layer in params["layers"]:
        keys = LAYER_KEYS + ("router",) if "router" in layer else LAYER_KEYS
        layers.append({k: _f32(layer[k]) for k in keys})
    out = {"emb": _f32(params["emb"]), "pos": _f32(params["pos"]), "layers": layers}
    d = out["emb"].shape[1]
    for layer in layers:
        shapes = {k: v.shape for k, v in layer.items()}
        want = {"wqkv": (d, 3 * d), "wo": (d, d), "ln1": (d,), "ln2": (d,),
                "w1": (d, 4 * d), "w2": (4 * d, d)}
        if "router" in layer:
            e = layer["router"].shape[-1]
            want.update(router=(d, e), w1=(e, d, 4 * d), w2=(e, 4 * d, d))
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


def _moe_ffn(layer: dict, y: torch.Tensor, cfg: SASRecConfig, valid=None):
    """Switch-style top-1 mixture-of-experts FFN, y (B, T, D) → (out, aux);
    the JAX function's semantics (``:169-218``).

    Routing is per batch row: each (row, expert) pair has
    ``max(1, int(expert_capacity · T / E))`` slots, filled in time order.
    ``argmax`` takes the first expert of a tie; a token past its expert's
    capacity gets a zero delta (the residual carries it). ``valid`` (B, T)
    takes pads out of routing and out of the load-balancing statistics.
    ``aux`` is the Switch loss E·Σ_e f_e·P_e over real tokens.
    """
    b, t, _ = y.shape
    e = cfg.n_experts
    cap = max(1, int(cfg.expert_capacity * t / e))
    probs = torch.softmax(y @ layer["router"], dim=-1)  # (B, T, E)
    gate = probs.amax(-1)  # a tie shares the gradient, as JAX's max does
    onehot = torch.nn.functional.one_hot(probs.argmax(-1), e).to(y.dtype)
    if valid is not None:
        onehot = onehot * valid[..., None].to(y.dtype)
    # the token's place in its (row, expert) queue: -1 for a pad, >= cap
    # for an overflow token, and for both the slot one-hot is a zero row
    pos = (onehot.cumsum(1) * onehot).sum(-1) - 1.0  # (B, T)
    slot = (pos[..., None] == torch.arange(cap, device=y.device, dtype=y.dtype)).to(y.dtype)
    dispatch = onehot[..., None] * slot[..., None, :]  # (B, T, E, C)
    xs = torch.einsum("btd,btec->becd", y, dispatch)
    h = torch.relu(torch.einsum("becd,edf->becf", xs, layer["w1"]))
    out = torch.einsum("becf,efd->becd", h, layer["w2"])
    yout = torch.einsum("becd,btec->btd", out, dispatch) * gate[..., None]
    if valid is None:
        n_real = torch.tensor(float(b * t), dtype=y.dtype, device=y.device)
        probs_real = probs
    else:
        vmask = valid[..., None].to(y.dtype)
        n_real = vmask.sum().clamp_min(1.0)
        probs_real = probs * vmask
    f = onehot.sum((0, 1)) / n_real
    p = probs_real.sum((0, 1)) / n_real
    return yout, e * (f * p).sum()


def _block_stack(params: dict, seq: torch.Tensor, cfg: SASRecConfig, pos, attention):
    """The transformer body: seq (B, T) → (hidden (B, T, D), MoE aux loss).

    ``pos`` is the positional table for these positions; ``attention``
    maps head-split (B, H, T, h) q/k/v, each contiguous, to the attention
    output (dense or the flash kernels, chosen by the caller). Pad rows are
    zeroed after every layer. The aux loss is 0 for a dense FFN.
    """
    hidden, aux = _block_stack_blocks(
        [params], [seq], cfg, [pos], lambda q, k, v: [attention(q[0], k[0], v[0])]
    )
    return hidden[0], aux


def _block_stack_blocks(params: list, seqs: list, cfg: SASRecConfig, poss: list, attention):
    """:func:`_block_stack` over the blocks of a split sequence, layer by
    layer in lockstep: block i has its params tree ``params[i]`` (on its
    device), ids ``seqs[i]`` and positional rows ``poss[i]``; ``attention``
    maps the lists of the blocks' head-split q/k/v to the list of their
    outputs (the ring, across blocks). Returns (hidden list, MoE aux)."""
    seqs = [s.long() for s in seqs]
    xs = [p["emb"][s] + pos[None, :, :] for p, s, pos in zip(params, seqs, poss)]
    pad_masks = [(s == PAD)[:, :, None] for s in seqs]
    h = cfg.d_model // cfg.n_heads
    aux_total = torch.zeros((), dtype=xs[0].dtype, device=xs[0].device)

    def heads(z):  # (B, T, D) → (B, H, T, h)
        return z.reshape(*z.shape[:-1], cfg.n_heads, h).transpose(-3, -2).contiguous()

    for li in range(len(params[0]["layers"])):
        layers = [p["layers"][li] for p in params]
        ys = [_layer_norm(x, layer["ln1"]) for x, layer in zip(xs, layers)]
        qkv = [(y @ layer["wqkv"]).split(cfg.d_model, dim=-1) for y, layer in zip(ys, layers)]
        outs = attention(*([heads(t[i]) for t in qkv] for i in range(3)))
        new = []
        for x, y, a, layer, s, pad_mask in zip(xs, ys, outs, layers, seqs, pad_masks):
            a = a.transpose(-3, -2).reshape(y.shape)
            x = x + a @ layer["wo"]
            y = _layer_norm(x, layer["ln2"])
            if cfg.n_experts:
                delta, aux = _moe_ffn(layer, y, cfg, valid=s != PAD)
                x = x + delta
                aux_total = aux_total + aux.to(aux_total.device)
            else:
                x = x + torch.relu(y @ layer["w1"]) @ layer["w2"]
            new.append(x.masked_fill(pad_mask, 0.0))
        xs = new
    return xs, aux_total


def _forward(params: dict, seq: torch.Tensor, cfg: SASRecConfig, allow_flash: bool = False):
    """seq (B, T) → (hidden (B, T, D), MoE aux loss). ``allow_flash`` sends
    every layer's attention through the flash kernels where the gate allows
    it; they are differentiable (the autograd Function's backward is the
    two backward kernels)."""
    if allow_flash and _use_flash(seq.shape[-1], seq.device):
        attention = partial(flash_attention, causal=True)
    else:
        attention = partial(full_attention, causal=True)
    return _block_stack(params, seq, cfg, params["pos"], attention)


def _predict_logits(params: dict, seq: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """(B, T) → (B, n_items): the last position against every item."""
    hidden, _ = _forward(params, seq, cfg, allow_flash=True)
    return hidden[:, -1, :] @ params["emb"][1:].T


def _masked_nll_sums(params: dict, hidden: torch.Tensor, inp: torch.Tensor, tgt: torch.Tensor):
    """(Σ masked nll, Σ mask): every position against every item, masked
    where the input or the target is a pad; the caller divides."""
    logits = hidden @ params["emb"][1:].T  # skip the pad row
    mask = (tgt != PAD) & (inp != PAD)
    logp = torch.log_softmax(logits, dim=-1)
    tgt0 = (tgt.long() - 1).clamp_min(0)  # back to 0-based item index
    nll = -logp.gather(-1, tgt0[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def _loss_fn(params: dict, seq: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """Causal next-item cross-entropy over seq (B, max_len + 1), plus the
    weighted MoE load-balancing loss; positions whose target is a pad are
    masked out. The gate inside ``_forward`` sends long blocks on the card
    through the flash kernels."""
    inputs, targets = seq[:, :-1], seq[:, 1:]
    hidden, aux = _forward(params, inputs, cfg, allow_flash=True)
    num, den = _masked_nll_sums(params, hidden, inputs, targets)
    return num / den.clamp_min(1) + cfg.moe_aux_weight * aux


def _sp_grid(ctx) -> list[list[torch.device]]:
    """The mesh's placements as a (data, model) grid (other axes at their
    first index)."""
    names, devs = ctx.mesh.axis_names, ctx.mesh.devices
    grid = [[None] * ctx.axis_size(MODEL_AXIS) for _ in range(ctx.axis_size(DATA_AXIS))]
    for coord in np.ndindex(*devs.shape):
        d = coord[names.index(DATA_AXIS)] if DATA_AXIS in names else 0
        m = coord[names.index(MODEL_AXIS)] if MODEL_AXIS in names else 0
        if grid[d][m] is None:
            grid[d][m] = devs[coord]
    return grid


def _build_sp_loss(ctx, sp_ways: int, cfg: SASRecConfig):
    """The loss with the sequence split over the ``model`` axis:
    ``loss(params, inp, tgt)`` over whole (B, T) inputs and targets, the
    one-token shift already done on the whole sequence.

    The batch splits over ``data`` and time over ``model`` (block (d, m) on
    the placement at that grid point); params are every placement's (one
    copy a device). Each block runs the transformer body on its slice of
    ``pos``, the attention the dense ring over its row's ``model``
    placements (``_ring_attention_block``), then its masked nll sums; the
    loss is the ``psum`` of the sums over every block, divided. Equal to
    the data-parallel :func:`_loss_fn` up to float32 rounding.
    """
    grid = _sp_grid(ctx)
    if len(grid[0]) != sp_ways:
        raise ValueError(f"the mesh's model axis has {len(grid[0])} placements, not {sp_ways}")

    def on(params, dev):
        return {
            "emb": params["emb"].to(dev),
            "pos": params["pos"].to(dev),
            "layers": [{k: t.to(dev) for k, t in layer.items()} for layer in params["layers"]],
        }

    def loss(params, inp, tgt):
        n_data = len(grid)
        b_local, t_local = inp.shape[0] // n_data, inp.shape[1] // sp_ways
        trees = {}
        nums, dens = [], []
        for d, devs in enumerate(grid):
            for dev in devs:
                if dev not in trees:
                    trees[dev] = on(params, dev)
            rows = slice(d * b_local, (d + 1) * b_local)
            cols = [slice(m * t_local, (m + 1) * t_local) for m in range(sp_ways)]
            seqs = [inp[rows, c].to(dev) for c, dev in zip(cols, devs)]
            tgts = [tgt[rows, c].to(dev) for c, dev in zip(cols, devs)]
            trees_row = [trees[dev] for dev in devs]
            poss = [tr["pos"][c] for tr, c in zip(trees_row, cols)]
            hidden, _ = _block_stack_blocks(
                trees_row, seqs, cfg, poss,
                lambda q, k, v: _ring_attention_block(q, k, v, causal=True, devices=devs),
            )
            for tr, hb, sb, tb in zip(trees_row, hidden, seqs, tgts):
                num, den = _masked_nll_sums(tr, hb, sb, tb)
                nums.append(num)
                dens.append(den)
        num, den = psum(nums)[0], psum(dens)[0]
        return num / den.clamp_min(1)

    return loss


class SASRecNet(torch.nn.Module):
    """The weights of one model on one device, placed once. Serving keeps
    them frozen (``requires_grad=False``, under ``no_grad``); training
    builds a ``trainable`` net."""

    def __init__(self, params: dict, cfg: SASRecConfig, device, trainable: bool = False):
        super().__init__()
        self.cfg = cfg

        def put(a):
            return torch.nn.Parameter(torch.tensor(_f32(a), device=device), requires_grad=trainable)

        self.emb = put(params["emb"])
        self.pos = put(params["pos"])
        self.layers = torch.nn.ModuleList(
            torch.nn.ParameterDict({k: put(v) for k, v in layer.items()})
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
            "layers": [dict(layer.items()) for layer in self.layers],
        }

    def host_params(self) -> dict:
        """The weights as a host float32 numpy tree (what a blob pickles)."""
        def host(t):
            return _f32(t.detach().cpu().numpy())

        return {
            "emb": host(self.emb),
            "pos": host(self.pos),
            "layers": [{k: host(v) for k, v in layer.items()} for layer in self.layers],
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
    # the training loss of each step, host float32; None for a model
    # trained elsewhere and carried across
    losses: Optional[np.ndarray] = None

    def __post_init__(self):
        self._net: Optional[SASRecNet] = None
        self._lock = threading.Lock()

    # the blob pickles the numpy params only, so it loads on any device
    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k not in ("_net", "_lock")}

    def __setstate__(self, state):
        # a JAX-package model has no losses
        _persistence.reconcile_state(self, state)
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


def build_sequences(interactions: Interactions, max_len: int) -> np.ndarray:
    """(n_users, max_len) right-aligned, time-ordered item ids (+1; 0 pads).
    The sort is a stable ``lexsort`` on (t, user): equal times keep the
    order the events came in."""
    order = np.lexsort((interactions.t, interactions.user))
    users = interactions.user[order]
    items = interactions.item[order]
    seqs = np.zeros((interactions.n_users, max_len), np.int32)
    bounds = np.flatnonzero(np.diff(users)) + 1
    for u_block, i_block in zip(np.split(users, bounds), np.split(items, bounds)):
        if len(u_block) == 0:
            continue
        tail = i_block[-max_len:]
        seqs[int(u_block[0]), -len(tail):] = tail + 1
    return seqs


def training_sequences(interactions: Interactions, cfg: SASRecConfig) -> np.ndarray:
    """The rows ``train_sasrec`` samples from: ``max_len + 1`` long (the
    input/target shift), users with at least 2 events (one transition)."""
    seqs = build_sequences(interactions, cfg.max_len + 1)
    seqs = seqs[(seqs != PAD).sum(1) >= 2]
    if len(seqs) == 0:
        raise ValueError(
            "no user has >= 2 interaction events; sequential training "
            "needs at least one (previous item -> next item) transition"
        )
    return seqs


def adam(net: SASRecNet, cfg: SASRecConfig) -> torch.optim.Adam:
    """Adam with optax's ``adam`` defaults (betas 0.9 and 0.999, eps 1e-8)."""
    return torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(net: SASRecNet, opt: torch.optim.Optimizer, seq: torch.Tensor, cfg: SASRecConfig,
               sp_loss=None):
    """One optimizer step on the batch ``seq`` (B, max_len + 1); returns
    the loss before the step, on the device. ``sp_loss`` (from
    :func:`_build_sp_loss`) takes the place of :func:`_loss_fn`, fed the
    inputs and targets shifted on the whole sequence."""
    opt.zero_grad(set_to_none=True)
    if sp_loss is not None:
        loss = sp_loss(net.tree(), seq[:, :-1], seq[:, 1:])
    else:
        loss = _loss_fn(net.tree(), seq, cfg)
    loss.backward()
    opt.step()
    return loss.detach()


def _all_reduce_grads(net: SASRecNet) -> None:
    """Sum every parameter's gradient across the launch's processes, in
    process order (one host-staged gather of the flattened gradients)."""
    from predictionio_tpu_torch.parallel import distributed

    params = [p for p in net.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    parts = distributed.gather_blocks([flat])
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    total = total.to(flat.device)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(total[off:off + n].view_as(p.grad))
        off += n


def dp_train_step(net: SASRecNet, opt: torch.optim.Optimizer, seq: torch.Tensor,
                  cfg: SASRecConfig):
    """One data-parallel step of a launch on this process's rows ``seq``:
    the masked nll sum over the global count of valid targets (summed
    across processes), gradients all-reduced, then the Adam step. Returns
    the global batch's loss."""
    from predictionio_tpu_torch.parallel import distributed

    opt.zero_grad(set_to_none=True)
    inputs, targets = seq[:, :-1], seq[:, 1:]
    hidden, _aux = _forward(net.tree(), inputs, cfg, allow_flash=True)
    num, den = _masked_nll_sums(net.tree(), hidden, inputs, targets)
    den_all = float(distributed.host_sum(np.array([float(den)]))[0])
    loss = num / max(den_all, 1.0)
    loss.backward()
    _all_reduce_grads(net)
    opt.step()
    return torch.tensor(
        float(distributed.host_sum(np.array([loss.item()], np.float64))[0]), dtype=torch.float32)


def _sharded_sequences(sh, cfg: SASRecConfig) -> tuple[np.ndarray, int]:
    """This process's training rows under a launch and the global count of
    trainable users. A process with no trainable user contributes one
    all-PAD row (zero valid targets), so every collective sees the same
    batch shape; no trainable user anywhere raises."""
    seqs = build_sequences(sh.user_rows, cfg.max_len + 1)
    seqs = seqs[(seqs != PAD).sum(1) >= 2]
    n_global = int((sh.user_counts >= 2).sum())
    if len(seqs) == 0:
        if n_global == 0:
            raise ValueError(
                "no user has >= 2 interaction events; sequential training "
                "needs at least one (previous item -> next item) transition"
            )
        logger.warning("process %d: no trainable sequence; contributing all-PAD rows",
                       sh.process_index)
        seqs = np.full((1, cfg.max_len + 1), PAD, seqs.dtype)
    return seqs, n_global


def train_sasrec(
    ctx,
    interactions: Interactions,
    config: Optional[SASRecConfig] = None,
    init_params: Optional[dict] = None,
) -> SASRecModel:
    """Train a SASRec on ``ctx.device``: one Adam step per epoch.

    What the JAX function does in one process: :func:`training_sequences`,
    ``batch = min(batch_size, n)`` (rounded to a multiple of the mesh's
    ``data`` axis, 1 on one device), ``np.random.default_rng(seed)``
    drawing ``integers(0, n, batch)`` rows per epoch, and Adam with optax's
    defaults (betas 0.9 and 0.999, eps 1e-8). The start is ``init_params``
    (a host param tree, e.g. the JAX ``_init_params`` draw as numpy), else
    :func:`init_params` from ``seed``. On the card at a flash-eligible
    ``max_len`` every layer's attention runs the flash kernels, backward
    included. With ``seq_parallel`` the step's loss is
    :func:`_build_sp_loss` over the mesh's (data, model) placements (a
    ``model`` axis of at least 2 that divides ``max_len``; no experts).
    The weights and Adam state live on ``ctx.device``. Returns host float32
    params and each step's loss (of the steps this call ran: a resumed run
    starts at its checkpoint's epoch).
    """
    from predictionio_tpu_torch.parallel.ingest import ShardedInteractions

    cfg = config or SASRecConfig()
    sharded = isinstance(interactions, ShardedInteractions)
    n_shards = ctx.axis_size(DATA_AXIS)
    if sharded:
        if cfg.seq_parallel or cfg.n_experts:
            raise ValueError(
                "sharded multi-host SASRec training is pure data "
                "parallelism; seq_parallel / n_experts claim the `model` "
                "axis across hosts and are not supported under pio launch"
            )
        n_hosts, pid = interactions.num_processes, interactions.process_index
        if n_shards % n_hosts:
            raise ValueError(f"{n_shards} device shards not divisible by {n_hosts} hosts")
        seqs, n_global = _sharded_sequences(interactions, cfg)
    else:
        n_hosts, pid = 1, 0
        seqs = training_sequences(interactions, cfg)
        n_global = len(seqs)
    n = len(seqs)
    # the JAX rule: the batch is a multiple of the data axis (1 on one
    # device), cut from the GLOBAL trainable count
    batch = pad_to_multiple(min(cfg.batch_size, pad_to_multiple(n_global, n_shards)), n_shards)
    sp_ways = ctx.axis_size(MODEL_AXIS) if cfg.seq_parallel else 1
    if cfg.seq_parallel:
        if cfg.n_experts:
            raise ValueError(
                "seq_parallel and n_experts both claim the `model` mesh axis; enable one "
                "of SP/EP per training run"
            )
        if sp_ways < 2:
            raise ValueError(
                "seq_parallel needs a mesh `model` axis of size >= 2 to shard the time "
                'dimension over (e.g. engine.json mesh: {"mesh_axes": {"data": N, '
                '"model": M}}, or a context with devices=[dev] * M); silently training '
                "replicated would defeat the flag's purpose"
            )
        if cfg.max_len % sp_ways:
            raise ValueError(
                f"max_len {cfg.max_len} not divisible by the model-axis size {sp_ways} "
                "required for sequence parallelism"
            )
    sp_loss = _build_sp_loss(ctx, sp_ways, cfg) if sp_ways > 1 else None
    start = init_params if init_params is not None else _draw_params(cfg.seed, cfg, interactions.n_items)
    start_epoch, manager, fingerprint, restored = 0, None, None, None
    if cfg.checkpoint_dir:
        from predictionio_tpu_torch.core import checkpoint as _checkpoint

        _checkpoint.validate_interval(cfg.checkpoint_interval)
        manager = _checkpoint.CheckpointManager(cfg.checkpoint_dir)
        # the JAX package's fields (models/sequential.py:525-545): under a
        # launch the global count, the exchanged row digest and the process
        # count, the same on every process
        fingerprint = np.array(
            [interactions.n_items, n_global, batch, cfg.d_model, cfg.n_layers, cfg.n_heads,
             cfg.max_len, float(cfg.lr), cfg.seed, cfg.n_experts,
             float(cfg.expert_capacity), float(cfg.moe_aux_weight),
             float(interactions.dataset_digest) if sharded else _checkpoint.dataset_digest(seqs),
             int(cfg.seq_parallel)] + ([n_hosts] if sharded else []),
            dtype=np.float64,
        )
        start_epoch, restored = _checkpoint.resume_from(manager, fingerprint, cfg.epochs)
        if restored is not None:
            start = restored["params"]
    net = SASRecNet(start, cfg, ctx.device, trainable=True)
    opt = adam(net, cfg)
    if restored is not None:
        opt.load_state_dict({
            "state": {int(i): {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
                      for i, st in restored["opt"].items()},
            "param_groups": opt.state_dict()["param_groups"],
        })
    rows = torch.from_numpy(seqs.astype(np.int64)).to(ctx.device)
    # under a launch each process draws its slice of the global batch from
    # its own users, with its own stream (process 0's is the one-process one)
    local_batch = batch // n_hosts
    rng = np.random.default_rng(cfg.seed + 1_000_003 * pid)
    for _ in range(start_epoch):  # resume: fast-forward the batch sampler
        rng.integers(0, n, local_batch)
    losses = []
    for epoch in range(start_epoch, cfg.epochs):
        picks = torch.from_numpy(rng.integers(0, n, local_batch)).to(ctx.device)
        if n_hosts > 1:
            losses.append(dp_train_step(net, opt, rows[picks], cfg))
        else:
            losses.append(train_step(net, opt, rows[picks], cfg, sp_loss))
        if manager is not None and _checkpoint.save_due(
            epoch + 1, cfg.checkpoint_interval, cfg.epochs
        ):
            manager.save(epoch + 1, {
                "params": net.host_params(),
                "opt": {str(i): st for i, st in opt.state_dict()["state"].items()},
                "fingerprint": fingerprint,
            })
    if sharded and interactions.cleanup is not None:
        from predictionio_tpu_torch.parallel import distributed

        if distributed.should_write_storage():
            interactions.cleanup()  # the steps were collectives: every exchange is done
    return SASRecModel(
        params=net.host_params(),
        item_map=interactions.item_map,
        config=cfg,
        losses=torch.stack(losses).cpu().numpy().astype(np.float32) if losses else np.zeros(0, np.float32),
    )
