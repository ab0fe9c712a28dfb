"""Training cells: the port's default train step as its trainer runs it.

Traffic: utterances of a fixed set of durations (``deck_*``, drawn from the
traffic file's own seed, so every run's seed gives the same sizes in
another order), cut from synthetic recordings made on the device, with
transcripts of ``tokens_per_s`` random pieces a second ending in EOS.
Each step featurises its A microbatches with the train pipeline
(SpecAugment, dither), packs the joint to ``pack_cap`` of the valid rows,
and takes the step: bf16, random state passing with the trainer's gates,
LAMB and the EMA.

Set-up builds the step once and drives it through its first steps (the
ones the reference follows); the window then runs whole steps for
``seconds`` and ends at a synchronise. After the window the program is
freed and the reference (``reference/train.py``) follows the first steps
from the same weights and microbatches; ``correct`` holds the losses, the
first gradient's per-tensor norms (read from LAMB's first moments) and
the parameters' per-tensor change to the limits."""

from __future__ import annotations

import gc
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import common
from benchmark.cell import Cell, Record, now
from benchmark.reference import train as ref_train
from benchmark.reference.precision import PRECISIONS, fp32_exact
from benchmark.reference.weights import make_weights

EOS_IDX = 1      # the tokenizer's first user-defined piece, after <unk>
FIRST_TOKEN = 2  # transcripts draw pieces from here to the blank
CHECKED = 3      # steps in set-up that the reference follows


class Traffic:
    """The general generator of training traffic, from the traffic file."""

    def __init__(self, t: dict, cfg: dict, seed: int, device):
        self.B = cfg["batch_size"]
        self.A = cfg["grad_accumulation_batches"]
        self.K = cfg["n_classes"]
        self.device = device
        deck = np.random.default_rng(t["deck_seed"]).normal(t["mean_s"], t["sd_s"],
                                                             t["deck_utterances"])
        self.deck = np.round(np.clip(deck, t["min_s"], t["max_s"]) * common.SR).astype(np.int64)
        self.rng = np.random.default_rng(common.derive_seed(seed, "traffic"))
        self.order = self.rng.permutation(len(self.deck))
        self.tokens_per_s = t["tokens_per_s"]
        gen = torch.Generator(device=device).manual_seed(common.derive_seed(seed, "audio"))
        rec = common.synthetic_recordings(t["recordings"], t["max_s"], gen, device)
        self.pool = common.to_int16_grid(rec).float() / 32768.0
        self.rec_len = self.pool.shape[1]
        self.made: Dict[int, List[dict]] = {}

    def microbatch(self, j: int) -> dict:
        D = len(self.deck)
        lens = self.deck[self.order[(j * self.B + np.arange(self.B)) % D]]
        r = self.rng.integers(0, self.pool.shape[0], self.B)
        off = self.rng.integers(0, self.rec_len - lens + 1)
        U = np.maximum(2, np.round(self.tokens_per_s * lens / common.SR)).astype(np.int64)
        txt = self.rng.integers(FIRST_TOKEN, self.K - 1, (self.B, int(U.max())))
        txt[np.arange(self.B), U - 1] = EOS_IDX
        txt[np.arange(U.max())[None, :] >= U[:, None]] = 0
        S = int(lens.max())
        dev = self.device
        idx = torch.from_numpy(off).to(dev)[:, None] + torch.arange(S, device=dev)[None]
        audio = self.pool[torch.from_numpy(r).to(dev)[:, None], idx.clamp(max=self.rec_len - 1)]
        audio = torch.where(torch.arange(S, device=dev)[None] < torch.from_numpy(lens).to(dev)[:, None],
                            audio, 0.0)
        return {"audio": audio, "audio_lens": torch.from_numpy(lens).to(dev), "lens": lens,
                "txt": torch.from_numpy(txt).to(dev), "txt_lens": torch.from_numpy(U).to(dev),
                "u": U}

    def step(self, i: int) -> List[dict]:
        """Step i's A microbatches (the same each time it is asked for)."""
        if i not in self.made:
            self.made[i] = [self.microbatch(i * self.A + a) for a in range(self.A)]
        return self.made[i]

    def forget(self, i: int) -> None:
        self.made.pop(i, None)


def frame_lens(lens: np.ndarray, rnnt: dict):
    """(pre-stack, post-stack) frames of each utterance from its samples:
    log-mel frames (15 ms of leading zeros, 25 ms windows, 10 ms hop),
    spliced by 3, stacked by the stack-time factor."""
    frames = np.maximum(0, (lens + 240 - 400) // 160 + 1)
    pre = -(-frames // 3)
    return pre, -(-pre // rnnt["enc_stack_time_factor"])


def valid_rows(lens: np.ndarray, U: np.ndarray, rnnt: dict) -> dict:
    """The rows each layer needs for these utterances."""
    pre, post = frame_lens(lens, rnnt)
    return {"pre": int(pre.sum()), "post": int(post.sum()), "pred": int((U + 1).sum()),
            "lattice": int((post * (U + 1)).sum()), "T_pre": int(pre.max()),
            "T_post": int(post.max()), "U1": int(U.max()) + 1}


def _program(cell: Cell, weights, dev):
    """The program's model, optimizer state and step, as the trainer builds
    them with the configuration's defaults."""
    from caiman_asr_tpu_torch.models.config import RNNTModelConfig
    from caiman_asr_tpu_torch.models.rnnt import RNNT
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.step import init_train_state, make_train_step

    cfg = cell.config
    rnnt = {k: v for k, v in cfg["rnnt"].items() if k in RNNTModelConfig.__dataclass_fields__}
    model = RNNT(RNNTModelConfig(**rnnt), cfg["n_classes"], device=dev)
    model.load_state_dict(weights, strict=True)
    opt = Lamb(OptimizerConfig(**cfg["optimizer"]), model.param_lr_factors())
    state = init_train_state(model, opt, device=dev)
    step = make_train_step(
        model, opt, cfg["n_classes"] - 1, ema_decay=cfg["optimizer"]["ema"], eos_idx=EOS_IDX,
        star_idx=-1, eos_penalty=0.0, compute_dtype=torch.bfloat16, grad_noise=False, rsp=True,
        collect_layer_stats=False, device=dev)
    names = {id(p): n for n, p in model.named_parameters()}
    return model, opt, state, step, names


def compare(prog: dict, ref: dict, limits: dict, rec: Record) -> None:
    """A training cell's numbers against their limits: the losses' gap; the
    first gradient's and the parameters' change's, each by the worst
    tensor, as the gap of the norms and as the norm of the difference, over
    the reference's norm of that tensor or the median tensor's, whichever is
    larger. Tensors whose reference gradient is nought to rounding (under a
    thousandth of the median tensor's) are left out: LAMB moves them by
    round-off alone."""
    rec.check("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                                    ref["losses"])),
              limits["loss_gap"])
    g_norm = {k: float(v.norm()) for k, v in ref["first_grad"].items()}
    g_med = statistics.median(g_norm.values())
    live = [k for k in g_norm if g_norm[k] >= 1e-3 * g_med]
    for key, name in (("first_grad", "grad"), ("change", "change")):
        p, r = prog[key], ref[key]
        norms = {k: float(r[k].norm()) for k in live}
        med = statistics.median(norms.values())
        gaps, diffs = {}, {}
        for k in live:
            pk = p[k].to(r[k].device)
            base = max(norms[k], med)
            gaps[k] = abs(float(pk.norm()) - norms[k]) / base
            diffs[k] = float((pk - r[k]).norm()) / base
        for label, d in ((f"{name}_gap", gaps), (f"{name}_diff", diffs)):
            worst = sorted(d.items(), key=lambda kv: -kv[1])
            rec.values[f"{label}_worst"] = [[k, v] for k, v in worst[:3]]
            rec.values[f"{label}_median"] = statistics.median(d.values())
            if label in limits:
                rec.check(label, worst[0][1], limits[label])


def step_seed(cell: Cell, i: int) -> int:
    """The seed of step i's generator (features and dropout)."""
    return common.derive_seed(cell.seed, "step", i)


def pack_to(micro: List[dict], rnnt: dict) -> Optional[int]:
    """The joint's rows for a step, as the trainer sets them: ``pack_cap``
    of the larger microbatch's valid lattice positions against the dense
    size at the step's padded shapes (the benchmark's copy of the rule, so
    that the reference takes nothing from the program)."""
    T = max(int(frame_lens(np.array([mb["audio"].shape[1]]), rnnt)[0][0]) for mb in micro)
    enc_t = -(-T // rnnt["enc_stack_time_factor"])
    dense_n = micro[0]["audio"].shape[0] * enc_t * (max(int(mb["u"].max()) for mb in micro) + 1)
    return common.pack_cap(max(valid_rows(mb["lens"], mb["u"], rnnt)["lattice"]
                               for mb in micro), dense_n)


def _reference_readings(cell: Cell, traffic: Traffic, dev, precision: str, fault: str = ""
                        ) -> dict:
    cfg = cell.config
    weights = make_weights(cfg["rnnt"], cfg["n_classes"], common.derive_seed(cell.seed, "weights"),
                           dev)
    steps = [{"micro": traffic.step(i), "seed": step_seed(cell, i),
              "pack_to": pack_to(traffic.step(i), cfg["rnnt"])}
             for i in range(cell.limits["follow_steps"])]
    out = ref_train.follow(cfg, weights, steps, PRECISIONS[precision], fault)
    change = {k: out["params"][k] - weights[k] for k in weights}
    return {"losses": out["losses"], "first_grad": out["first_grads"], "change": change}


def run(cell: Cell) -> Record:
    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.ops.features import SpecAugmentConfig
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
    from caiman_asr_tpu_torch.train import stack_microbatches
    from caiman_asr_tpu_torch.training.pack import pack_cap
    from caiman_asr_tpu_torch.training.rsp import RSPController, zero_rnnt_state
    from caiman_asr_tpu_torch.training.tree import tree_items

    fp32_exact()
    dev = torch.device(cell.device)
    cfg, rec = cell.config, Record()
    rnnt, A, B = cfg["rnnt"], cfg["grad_accumulation_batches"], cfg["batch_size"]
    traffic = Traffic(cell.traffic, cfg, cell.seed, dev)
    follow = cell.limits["follow_steps"]

    if cell.control:
        # the reference in fp32 against itself put in the program's place,
        # one precision below or with a fault planted; several, separated by
        # commas, share one reading of the reference
        controls = cell.control.split(",")
        for c in controls:
            if c != "fp8" and c not in ref_train.FAULTS:
                raise ValueError(f"--control {c}: fp8 or one of {ref_train.FAULTS}")
        ref = _reference_readings(cell, traffic, dev, "fp32")
        for c in controls:
            other = _reference_readings(cell, traffic, dev, "fp8" if c == "fp8" else "fp32",
                                        "" if c == "fp8" else c)
            one = Record()
            compare(other, ref, cell.limits, one)
            del other
            rec.checks.update({f"{c}.{k}": v for k, v in one.checks.items()})
            rec.values[c] = one.values
        return rec

    weights = make_weights(rnnt, cfg["n_classes"], common.derive_seed(cell.seed, "weights"), dev)
    model, opt, state, step, names = _program(cell, weights, dev)
    pipe = FeaturePipeline(PipelineConfig(logmel=LogMelConfig(dither=cfg["dither"]),
                                          specaugment=SpecAugmentConfig(**cfg["spec_augment"])),
                           None, train=True, device=dev)
    rsp = cfg["rsp"]
    ctl = RSPController(rsp["seq_len_freq"], rsp["delay"], seed=common.derive_seed(cell.seed, "rsp"))
    carried = [zero_rnnt_state(model, B, device=dev)]
    scalars = {"delay_penalty": 0.0, "star_penalty": 0.0, "grad_noise_std": 0.0}

    def one_step(i: int):
        micro = traffic.step(i)
        gen = torch.Generator(device=dev).manual_seed(step_seed(cell, i))
        mbs = []
        for mb in micro:
            feats, fl = pipe(mb["audio"], mb["audio_lens"], gen, dataset_to_utt_ratio=0.0)
            mbs.append({"feats": feats, "feat_lens": fl, "txt": mb["txt"],
                        "txt_lens": mb["txt_lens"]})
        stacked = stack_microbatches(mbs)
        enc_t = -(-stacked["feats"].shape[1] // rnnt["enc_stack_time_factor"])
        dense_n = B * enc_t * (stacked["txt"].shape[2] + 1)
        nvalid = [valid_rows(mb["lens"], mb["u"], rnnt)["lattice"] for mb in micro]
        rows = pack_cap(max(nvalid), dense_n)
        if i < follow and rows != pack_to(micro, rnnt):
            raise RuntimeError(f"step {i}: the trainer packs to {rows} rows, the reference "
                               f"would take {pack_to(micro, rnnt)}")
        gates = ctl.gates(i, A)
        new, metrics, carried[0] = step(state_box[0], stacked, gen, scalars, carried[0], gates,
                                        pack_to=rows)
        state_box[0] = new
        if metrics["skipped"]:
            ctl.reset()
        return metrics, {"micro": micro, "pack_to": rows, "U1": stacked["txt"].shape[2] + 1}

    state_box = [state]
    del state

    # the program's readings, kept on the host: the gradient LAMB took at
    # the first step (its first moment over 1 - beta1) and the parameters'
    # change over the steps the reference follows
    prog = {"losses": []}
    b1 = cfg["optimizer"]["beta1"]
    by_path = {path: names[id(leaf)] for path, leaf in tree_items(state_box[0].params)}
    for i in range(CHECKED):
        m, _ = one_step(i)
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["first_grad"] = {by_path[p]: (leaf / (1.0 - b1)).cpu()
                                  for p, leaf in tree_items(state_box[0].opt_state.mu)}
        if i + 1 == follow:
            prog["change"] = {by_path[p]: (leaf.detach() - weights[by_path[p]]).cpu()
                              for p, leaf in tree_items(state_box[0].params)}
    prog["losses"] = prog["losses"][:follow]
    del weights
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    # the window
    rec.setup_s = now() - cell.t_start
    t0, i, steps, ends = now(), CHECKED, [], []
    while now() - t0 < cell.seconds:
        m, info = one_step(i)
        steps.append((int(m["skipped"]), info))
        ends.append(now() - t0)
        if i >= follow:
            traffic.forget(i)
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.window_s = now() - t0
    rec.attempted = A * len(steps)
    rec.failed = A * sum(s for s, _ in steps)
    done = [info for s, info in steps if not s]
    rec.values["audio_s"] = sum(float(mb["lens"].sum()) / common.SR for info in done
                                for mb in info["micro"])
    rec.values["steps"] = len(steps)
    # the spread within the run: each step's host time (the loop reads each
    # step's skip flag, so a step ends on the host when its device work does)
    # and the rate over the first and the second half of the steps
    took = np.diff([0.0] + ends)
    rec.values["step_s_quartiles"] = [float(q) for q in np.quantile(took, [0.25, 0.5, 0.75])]
    h = len(steps) // 2
    audio = [sum(float(mb["lens"].sum()) / common.SR for mb in info["micro"]) for _, info in steps]
    rec.values["half_rates"] = [sum(audio[:h]) / ends[h - 1],
                                sum(audio[h:]) / (ends[-1] - ends[h - 1])] if h else None
    rows = [valid_rows(mb["lens"], mb["u"], rnnt) for info in done for mb in info["micro"]]
    rec.values["model_flops"] = 3.0 * sum(common.model_forward_flops(
        rnnt, cfg["n_classes"], r["pre"], r["post"], r["pred"], r["lattice"]) for r in rows)
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    if cell.trace:
        last = steps[-1][1]
        _trace(cell, rec, one_step, i, last, model, state_box[0], dev)

    # the program's state freed, then the reference
    del model, opt, state_box, step, carried, pipe, steps, done
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = now()
    ref = _reference_readings(cell, traffic, dev, "fp32")
    compare(prog, ref, cell.limits, rec)
    rec.values["check_s"] = now() - t_check
    rec.values["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    return rec


def _trace(cell: Cell, rec: Record, one_step, i: int, last: dict, model, state, dev) -> None:
    """The traced run's extra readings, after the window: two whole steps
    under a trace of the device alone (busy and window), two more under a
    trace of the host's operations too (the idle gaps' attribution), then
    each layer's own entry at the last step's shapes."""
    from caiman_asr_tpu_torch.ops import joint_kernel
    from caiman_asr_tpu_torch.ops.transducer_loss import rnnt_lattice

    cfg = cell.config
    rnnt, K = cfg["rnnt"], cfg["n_classes"]
    Hj = rnnt["joint_n_hid"]
    nxt = [i]

    def two_steps():
        one_step(nxt[0])
        one_step(nxt[0] + 1)
        nxt[0] += 2

    rec.trace = common.traced(two_steps)
    rec.values["step_s"] = {"window": rec.window_s / rec.values["steps"],
                            "device_traced": rec.trace["window_s"] / 2,
                            "host_traced": rec.trace["host_traced_window_s"] / 2}

    mb = last["micro"][-1]
    rows = valid_rows(mb["lens"], mb["u"], rnnt)
    B = mb["audio"].shape[0]
    n = last["pack_to"] or B * rows["T_post"] * last["U1"]
    g = torch.Generator(device=dev).manual_seed(0)
    h = (torch.rand((n, Hj), generator=g, device=dev) * 0.5).to(torch.bfloat16).requires_grad_()
    w = (torch.randn((Hj, K), generator=g, device=dev) / Hj ** 0.5).to(torch.bfloat16)
    w.requires_grad_()
    b = torch.zeros(K, device=dev, requires_grad=True)
    lab = torch.randint(0, K - 1, (n,), generator=g, device=dev)

    def joint():
        lp_b, lp_l = joint_kernel.fused_joint_lse(h, w, b, lab, K - 1)
        torch.autograd.grad(lp_b.sum() + lp_l.sum(), (h, w, b))

    joint_ms = common.cuda_ms(joint, reps=3)
    rec.values["joint"] = {"ms": joint_ms, "bound_ms": common.joint_bound_ms(rows["lattice"], Hj,
                                                                              K)[0],
                           "rows_run": n, "rows_valid": rows["lattice"]}

    from caiman_asr_tpu_torch.data.featurize import FeaturePipeline
    from caiman_asr_tpu_torch.models.config import PipelineConfig
    from caiman_asr_tpu_torch.training.step import _cast_compute
    from caiman_asr_tpu_torch.training.tree import tree_items

    feats, fl = FeaturePipeline(PipelineConfig(), None, device=dev)(mb["audio"], mb["audio_lens"])
    params, x = _cast_compute(state.params, feats, torch.bfloat16)
    leaves = [p for _, p in tree_items(state.params)]

    def lstm():
        (f, _), (gg, _), _ = model.enc_pred(x, fl, mb["txt"], mb["txt_lens"], params=params,
                                            train=True, generator=g)
        torch.autograd.grad(f.float().sum() + gg.float().sum(), leaves, allow_unused=True)

    lstm_ms = common.cuda_ms(lstm, reps=2)
    rec.values["lstm"] = {"ms": lstm_ms, "bound_ms": common.lstm_stack_bound_ms(
        rnnt, rows["pre"], rows["post"], rows["pred"], rows["T_pre"], rows["T_post"], rows["U1"],
        B)}

    T1, U1 = rows["T_post"], last["U1"]
    lat = []
    for _ in range(3):
        null = (torch.randn((B, T1, U1), generator=g, device=dev) - 9.0).requires_grad_()
        emit = (torch.randn((B, T1, U1), generator=g, device=dev) - 9.0).requires_grad_()
        t_lens = torch.from_numpy(frame_lens(mb["lens"], rnnt)[1]).to(dev)
        torch.cuda.synchronize(dev)
        t0 = now()
        nll = rnnt_lattice(null, emit, t_lens, mb["txt_lens"])
        torch.autograd.grad(nll.sum(), (null, emit))
        torch.cuda.synchronize(dev)
        lat.append(1e3 * (now() - t0))
    rec.values["lattice_ms"] = statistics.median(lat)
    rec.values["lattice_shape"] = [B, T1, U1]
