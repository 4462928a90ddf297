"""The SASRec family's adapter: the one place that names the program's
SASRec functions. One mode, ``train``: set-up draws ML-1M-shaped events and
the weights from the seed, builds the program's ``training_sequences``
(moved to the device once), ``SASRecNet`` and ``adam``, and runs the first
``check_steps`` steps through the window's own call on rows that all
differ, reading what the check compares; a unit of the window is one
``train_step`` of the same object on a batch of rows drawn from the seed,
as ``train_sasrec`` draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.generators import zipf
from portbench.reference import compare
from portbench.reference import sasrec as ref_sasrec

BETA1 = 0.9


def draw_events(config: dict, seed: int):
    return zipf.ml1m_interactions(harness.seeds(seed, 4)[0] % (2 ** 32), config["n_users"],
                                  config["n_events"], config["min_events"], config["n_items"])


def draw_params(config: dict, max_len: int, seed: int, device) -> dict:
    """The weights from the seed, drawn on ``device`` in one call at the
    program's scales (embeddings N(0, 0.02²), each projection N(0, 1/fan
    in), layer-norm gains 1): a host float32 tree."""
    d, n_items, n_layers = config["d_model"], config["n_items"], config["n_layers"]
    shapes = [("emb", (n_items + 1, d), 0.02), ("pos", (max_len, d), 0.02)]
    for i in range(n_layers):
        shapes += [(f"{i}.wqkv", (d, 3 * d), d ** -0.5), (f"{i}.wo", (d, d), d ** -0.5),
                   (f"{i}.w1", (d, 4 * d), d ** -0.5), (f"{i}.w2", (4 * d, d), (4 * d) ** -0.5)]
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(harness.seeds(seed, 4)[1])
    flat = torch.randn(sum(sizes), generator=gen, device=device).cpu().numpy()
    out, off = {}, 0
    for (name, shape, scale), n in zip(shapes, sizes):
        out[name] = (flat[off:off + n].reshape(shape) * np.float32(scale)).astype(np.float32)
        off += n
    ones = np.ones(d, np.float32)
    layers = [{"wqkv": out[f"{i}.wqkv"], "wo": out[f"{i}.wo"], "ln1": ones.copy(),
               "ln2": ones.copy(), "w1": out[f"{i}.w1"], "w2": out[f"{i}.w2"]}
              for i in range(n_layers)]
    return {"emb": out["emb"], "pos": out["pos"], "layers": layers}


def check_rows(n_rows: int, batch: int, steps: int, seed: int) -> np.ndarray:
    """(steps, batch) row indices for the checked steps, all different."""
    rng = np.random.default_rng(harness.seeds(seed, 4)[2])
    return rng.permutation(n_rows)[:steps * batch].reshape(steps, batch)


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        if mix["mode"] != "train":
            raise ValueError(f"the SASRec adapter runs 'train', not {mix['mode']!r}")
        self.max_len, self.batch = int(mix["max_len"]), int(mix["batch"])
        self.setup_spans: dict = {}
        self.failed = 0

    def setup(self) -> None:
        from predictionio_tpu_torch.data.batch import interactions_from_arrays
        from predictionio_tpu_torch.models import sequential as sq

        c = self.config
        self.events = draw_events(c, self.seed)
        user, item, t, _ = self.events
        inter = interactions_from_arrays(
            user, item, np.ones(len(user)), t, (f"u{i}" for i in range(c["n_users"])),
            (f"si{j}" for j in range(c["n_items"])))
        self.cfg = sq.SASRecConfig(d_model=c["d_model"], n_layers=c["n_layers"],
                                   n_heads=c["n_heads"], max_len=self.max_len,
                                   batch_size=self.batch, lr=c["lr"])
        seqs = sq.training_sequences(inter, self.cfg)
        # each row's positions whose input and target are both items
        self.row_loss_positions = np.maximum((seqs != 0).sum(1) - 1, 0)
        self.rows = torch.from_numpy(seqs.astype(np.int64)).to(self.device)
        self.init = draw_params(c, self.max_len, self.seed, self.device)
        self.net = sq.SASRecNet(self.init, self.cfg, self.device, trainable=True)
        self.opt = sq.adam(self.net, self.cfg)
        self.rng = np.random.default_rng(harness.seeds(self.seed, 4)[3])
        self.check_picks = check_rows(len(seqs), self.batch, int(self.mix["check_steps"]),
                                      self.seed)
        self._checked_steps()

    def _step(self, picks: np.ndarray):
        from predictionio_tpu_torch.models import sequential as sq

        rows = self.rows[torch.from_numpy(picks).to(self.device)]
        return sq.train_step(self.net, self.opt, rows, self.cfg)

    def _checked_steps(self) -> None:
        """The first steps through the window's own call, read for the
        check: each loss, the first gradient from Adam's first moment, and
        each leaf's change after the last of them."""
        named = dict(self.net.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        losses, grad_norms = [], {}
        for i, picks in enumerate(self.check_picks):
            losses.append(self._step(picks))
            if i == 0:
                grad_norms = {k: float(self.opt.state[p]["exp_avg"].double().norm()) / (1 - BETA1)
                              if p in self.opt.state else 0.0 for k, p in named.items()}
        self.program = {
            "losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": {k: float((p.detach().double() - start[k].double()).norm())
                             for k, p in named.items()},
        }

    def begin_window(self) -> None:
        self.steps = 0
        self.loss_positions = 0

    def unit(self) -> None:
        picks = self.rng.integers(0, len(self.row_loss_positions), self.batch)
        self._step(picks)
        self.steps += 1
        self.loss_positions += int(self.row_loss_positions[picks].sum())

    def counts(self) -> dict:
        return {"steps": self.steps, "positions": self.steps * self.batch * self.max_len,
                "loss_positions": self.loss_positions, "attempted": self.steps}

    def shapes(self) -> dict:
        c = self.config
        return {"batch": self.batch, "t": self.max_len, "d": c["d_model"],
                "n_layers": c["n_layers"], "n_heads": c["n_heads"], "n_items": c["n_items"]}

    def kernels(self) -> dict:
        """label → (kernels 4-6's device names, those launched once a call)."""
        names = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
        return {"flash": (names, names)}

    def launch_counts(self) -> dict:
        """The program's own launch counters of kernels 4-6."""
        from predictionio_tpu_torch.ops import flash_attention as fa

        return {"flash": fa.launches.count + fa.bwd_dq_launches.count + fa.bwd_dkv_launches.count}

    def release(self) -> None:
        for name in ("net", "opt", "rows"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> dict:
        reference = reference_steps(self.config, self.max_len, self.events, self.init,
                                    self.check_picks, self.device, "f64")
        numbers = compare.train_numbers(self.program, reference)
        self.failed = int(not all(numbers[k] <= limits[k] for k in numbers))
        self.details = compare.train_details(self.program, reference)
        return numbers


def reference_steps(config, max_len, events, init, picks, device, precision) -> dict:
    user, item, t, _ = events
    seqs = ref_sasrec.sequences(user, item, t, config["n_users"], max_len + 1)
    batches = [torch.from_numpy(seqs[p]) for p in picks]
    return ref_sasrec.train_steps(init, batches, config["n_heads"], config["lr"], precision,
                                  device)


def control(config: dict, mix: dict, seed: int, device, details: dict = None) -> dict:
    """The control: the reference in TF32 put in the program's place, its
    numbers against the float64 reference, on the cell's own inputs;
    ``details``, where given, receives what the numbers are made of."""
    device = torch.device(device)
    max_len, batch = int(mix["max_len"]), int(mix["batch"])
    events = draw_events(config, seed)
    init = draw_params(config, max_len, seed, device)
    n_rows = int((np.bincount(events[0], minlength=config["n_users"]) >= 2).sum())
    picks = check_rows(n_rows, batch, int(mix["check_steps"]), seed)
    ref = reference_steps(config, max_len, events, init, picks, device, "f64")
    ctl = reference_steps(config, max_len, events, init, picks, device, "tf32")
    if details is not None:
        details.update(compare.train_details(ctl, ref))
    return compare.train_numbers(ctl, ref)


# -- faults planted underneath the timed path, for the check's own test ---------


def faults(mode: str) -> dict:
    """name → a context manager that breaks the program underneath the
    window's call in one way a training step can break."""
    from predictionio_tpu_torch.models import sequential as sq

    def unchanged(step):
        def call(net, opt, seq, cfg, sp_loss=None):
            opt.zero_grad(set_to_none=True)
            return sq._loss_fn(net.tree(), seq, cfg).detach()  # no update
        return call

    def half_batch(loss_fn):
        return lambda params, seq, cfg: loss_fn(params, seq[: len(seq) // 2], cfg)

    def moved_twice(step):
        def call(net, opt, seq, cfg, sp_loss=None):
            leaf = net.layers[-1]["w2"]
            before = leaf.detach().clone()
            out = step(net, opt, seq, cfg, sp_loss)
            with torch.no_grad():  # one leaf's update applied twice where it is made
                leaf.add_(leaf - before)
            return out
        return call

    return {"state_unchanged": lambda: harness.bracket_attr(sq, "train_step", unchanged),
            "half_batch": lambda: harness.bracket_attr(sq, "_loss_fn", half_batch),
            "answer_altered": lambda: harness.bracket_attr(sq, "train_step", moved_twice)}
