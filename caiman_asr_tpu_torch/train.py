"""Training entry point (the port of ``caiman_asr_tpu/train.py``; reference
training/caiman_asr_train/train.py:83-528), on one process or several.

Step-based training: the host loader feeds audio batches; on the device
the train ``FeaturePipeline`` (log-mel, normalisation blend, splicing,
SpecAugment) and the train step (gradient accumulation over A microbatches,
random state passing, the packed joint, LAMB, the EMA, the non-finite skip)
run. Host-side schedules (the delay and star penalties, the gradient
noise, the mel-normalisation ramp, the noise SNRs) feed each step its
scalars. Every ``--val_frequency`` steps the EMA weights are validated
(``evaluate/core.py``); checkpoints (``best``, ``step{N}``, ``last``) are in
the JAX package's format, so either package resumes the other's, and a
serving bundle is written after each best checkpoint when its gates pass.

Run:  python -m caiman_asr_tpu_torch.train --model_config configs/base-8703sp.yaml \\
        --dataset_dir D --train_manifests train.json --val_manifests dev.json \\
        --output_dir OUT --mel_stats_path D/mel_stats.npz [the JAX flags]

Over several cards, one process a card: ``python -m torch.distributed.run
--nproc_per_node N -m caiman_asr_tpu_torch.train --multihost ...`` (or
``--multihost`` with ``--coordinator_address``, ``--num_hosts`` and
``--host_id``; under the launcher the process group is joined with or
without the flag). ``--global_batch_size`` is then each process's: the
sampler's global batch is W times it and rank r takes ``batch[r::W]``. The
step computes the JAX step over the global batch (``training/step.py``);
ranks stop together (a stop flag all-reduced after each step, and an
epoch ends on every rank once one has no whole group left); only rank 0
writes checkpoints, logs, the train sample and serving bundles, and each
checkpoint holds every rank's host random streams and the carried RSP
state in the global batch's row order.

``--pruned_loss_range S`` trains on the pruned two-stage loss
(``ops/pruned_loss.py``, ``--simple_loss_scale``); the state then holds its
heads, which the checkpoints carry, and packing is off (the band bounds the
joint), as in the JAX trainer.

``--model_parallel M`` splits the processes into (data x model) groups
(``parallel/mesh.init_model_parallel``): the M ranks of a model group load
the same rows and each holds one vocab shard of the joint's last layer (and
of the pruned loss's heads), the step running the vocab-parallel joint
(``training/step.make_train_step_tp``); ``--global_batch_size`` is then a
data rank's. On one card: ``python -m torch.distributed.run
--nproc_per_node M -m caiman_asr_tpu_torch.train --model_parallel M ...``.
Checkpoints hold the whole tensors (rank 0 writes what the model group
gathers), so either package, and any layout, resumes them. A world that is
not a multiple of M, a vocabulary or a batch that does not divide, random
state passing and batch-norm models are refused.

It runs on the card and raises without one; ``main(args, device="cpu")``
runs on the CPU. Random streams are derived, never chained: the features
of microbatch ``a`` of step ``s`` draw from a generator seeded by
``(seed, s * (A + 1) + a)``, the step's dropout and gradient noise from
``(seed, s * (A + 1) + A)`` (on data rank r > 0 with r folded in, so that a
model group draws alike; the gradient noise over several ranks from a
generator without it), and the host loader's random streams ride the
checkpoint (``meta["_host_rng"]``), so that ``--resume`` reproduces the
uninterrupted run bit for bit. Not ported, raising and naming its
``ROADMAP.md`` item: a hub ``--noise_dataset``. ``--use_hugging_face``
validates from a HuggingFace dataset, as in the JAX trainer; training reads
manifests or tar shards all the same.
"""

from __future__ import annotations

import json
import os
import signal
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from caiman_asr_tpu_torch.args.train import train_arg_parser
from caiman_asr_tpu_torch.training.schedules import (
    ConstantSchedule,
    GradNoiseSchedule,
    MelNormRamp,
    StepSchedule,
)
from caiman_asr_tpu_torch.training.tree import tree_items

SKIP_WINDOW = 100  # the skipped-step alarm's window; all skipped in it aborts
# extra words of a derived seed: a rank's own streams, and the gradient
# noise that every rank draws alike
RANK_TAG, NOISE_TAG = 0x72616E6B, 0x6E6F6973


def derived_seed(seed: int, index: int, *more: int) -> int:
    """A 63-bit generator seed, a fixed function of ``(seed, index, *more)``."""
    state = np.random.SeedSequence([seed, index, *more]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def derived_generator(seed: int, index: int, device, rank: int = 0) -> torch.Generator:
    """The generator of ``(seed, index)``, rank r > 0's own for r folded in:
    rank 0 draws what one process draws."""
    more = (RANK_TAG, rank) if rank else ()
    return torch.Generator(device=device).manual_seed(derived_seed(seed, index, *more))


def stack_microbatches(micro, T: int = 0, U: int = 0):
    """Stack A microbatch dicts (padding T and U to the group's longest, or
    to ``T`` and ``U`` where longer: the longest over the ranks) into the
    [A, ...] layout the train step takes."""
    T = max([T] + [m["feats"].shape[0] for m in micro])
    U = max([U] + [m["txt"].shape[1] for m in micro])
    pad = torch.nn.functional.pad
    return {
        "feats": torch.stack([pad(m["feats"], (0, 0, 0, 0, 0, T - m["feats"].shape[0]))
                              for m in micro]),
        "feat_lens": torch.stack([m["feat_lens"] for m in micro]),
        "txt": torch.stack([pad(m["txt"], (0, U - m["txt"].shape[1])) for m in micro]),
        "txt_lens": torch.stack([m["txt_lens"] for m in micro]),
    }


def build_penalty_schedule(args, value_attr="delay_penalty", prefix="dp"):
    """A constant, or (the value ``"linear_schedule"``) a ``StepSchedule``
    from ``{prefix}_initial_value``, ``_final_value``, ``_toggle_step`` and
    ``_wer_threshold``: the delay penalty's and the star penalty's."""
    val = getattr(args, value_attr)
    if val == "linear_schedule":
        return StepSchedule(
            getattr(args, f"{prefix}_initial_value"),
            getattr(args, f"{prefix}_final_value"),
            toggle_step=getattr(args, f"{prefix}_toggle_step"),
            wer_threshold=getattr(args, f"{prefix}_wer_threshold"),
        )
    return ConstantSchedule(float(val or 0.0))


@torch.no_grad()
def copy_tree(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (one layout)."""
    src_items = dict(tree_items(src))
    for path, t in tree_items(dst):
        t.copy_(src_items[path])


def _make_epoch_tail(loader, epoch: int, accum: int, step: int) -> None:
    """Make, and drop, the batches of ``epoch`` past its last whole group of
    ``accum``: a run that went through that epoch made them, drawing from
    the host random streams, before it began the next, as for ``step`` (the
    next epoch's first)."""
    batches = loader.sampler.epoch_batches(epoch)
    for b in batches[len(batches) - len(batches) % accum:]:
        loader.make_batch(loader.sampler.shard(b, loader.rank), step)


def _rsp_state_from_leaves(template, leaves):
    """The carried state of ``template``'s layout from saved ``rsp/<i>``
    leaves (the JAX flatten order), on its device and in its dtypes."""
    from caiman_asr_tpu_torch.training.step import map_state

    it = iter(leaves)
    return map_state(lambda t: torch.as_tensor(np.asarray(next(it))).to(t.device, t.dtype),
                     template)


def _rsp_leaves(rnnt_state) -> list:
    from caiman_asr_tpu_torch.training.step import map_state

    out = []
    map_state(out.append, rnnt_state)
    return out


def _batch_axis(leaf) -> int:
    """The batch axis of a carried-state leaf: (h, c) [L, B, H], the last
    token [B, 1]."""
    return 1 if leaf.ndim == 3 else 0


def _per_rank(host_rng) -> bool:
    """Whether saved host streams are a list a rank (several processes) or
    one process's list of states."""
    return bool(host_rng) and all(isinstance(x, list) for x in host_rng)


def main(args=None, *, device="cuda"):
    """Train as the flags say; returns (the final ``TrainState``, the best
    dev WER)."""
    from caiman_asr_tpu_torch.args.train import resolve_train_dataset_yaml
    from caiman_asr_tpu_torch.device import resolve_device
    from caiman_asr_tpu_torch.evaluate.core import evaluate
    from caiman_asr_tpu_torch.export.checkpointer import Checkpointer, load_extra
    from caiman_asr_tpu_torch.log import MetricLogger, init_log
    from caiman_asr_tpu_torch.log.profiling import PhaseTimers, Profiler, ResourceRecorder
    from caiman_asr_tpu_torch.models.config import load_config
    from caiman_asr_tpu_torch.parallel import mesh
    from caiman_asr_tpu_torch.setup.builders import (
        apply_input_overrides,
        build_data_source_loader,
        build_decoder,
        build_feature_pipelines,
        build_model,
        build_tokenizer,
        load_mel_stats,
        normalize_config_from,
    )
    from caiman_asr_tpu_torch.training.optimizer import Lamb, OptimizerConfig
    from caiman_asr_tpu_torch.training.pack import lattice_nvalid, pack_cap
    from caiman_asr_tpu_torch.training.rsp import (
        RSPController,
        is_rsp_on,
        rsp_delay_default,
        zero_rnnt_state,
    )
    from caiman_asr_tpu_torch.parallel.vocab_parallel import gather_tree
    from caiman_asr_tpu_torch.training.step import (
        gather_state,
        init_train_state,
        make_train_step,
        make_train_step_tp,
        make_val_loss_step,
        shard_state,
    )
    from caiman_asr_tpu_torch.utils.user_tokens import user_token_idx

    if args is None:
        args = train_arg_parser().parse_args()
    joined = False
    if ((getattr(args, "multihost", False) or "WORLD_SIZE" in os.environ)
            and not mesh.is_initialized()):
        mesh.init_multihost(args.coordinator_address, args.num_hosts, args.host_id,
                            device=device)
        joined = True
    mp = max(int(getattr(args, "model_parallel", 1) or 1), 1)
    pruned_range = int(getattr(args, "pruned_loss_range", 0) or 0)
    if mp > 1:
        if args.global_batch_size % args.grad_accumulation_batches:
            raise ValueError(f"--model_parallel: a data rank's --global_batch_size "
                             f"{args.global_batch_size} does not divide into "
                             f"--grad_accumulation_batches {args.grad_accumulation_batches}")
        mesh.init_model_parallel(mp)  # raises where the world is no multiple of mp
    rank, world = mesh.rank(), mesh.world()
    # the gradients' group (one rank a vocab shard), the vocab shards' group
    group, model_group = mesh.data_group(), mesh.model_group()
    data_rank = mesh.data_rank()
    lead = rank == 0  # the one rank that writes
    dev = mesh.device() or resolve_device(device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    run_ts = getattr(args, "timestamp", None) or str(int(time.time()))
    if lead:
        logger = init_log(out_dir, enable_tensorboard=args.tensorboard,
                          log_file=getattr(args, "log_file", None), timestamp=run_ts)
        (out_dir / f"training_args_{run_ts}.json").write_text(
            json.dumps(vars(args), default=str, indent=1))
    else:
        logger = MetricLogger(None, stdout=False)

    resolve_train_dataset_yaml(args)
    cfg = apply_input_overrides(load_config(args.model_config, args.max_duration), args)
    # the subword sampling's stream seeded, so that a run repeats itself
    tokenizer = build_tokenizer(cfg, args.tokenizer_model, seed=args.seed)
    model, blank_idx = build_model(cfg, tokenizer, args, device=dev)
    if model.n_classes % mp:
        raise ValueError(f"--model_parallel {mp} must divide the {model.n_classes} classes "
                         "(equal vocab shards)")
    model.init_weights(torch.Generator(device=dev).manual_seed(args.seed))
    optimizer = Lamb(OptimizerConfig(
        lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
        clip_norm=args.clip_norm, beta1=args.beta1, beta2=args.beta2,
        warmup_steps=args.warmup_steps, hold_steps=args.hold_steps,
        half_life_steps=args.half_life_steps, ema=args.ema), model.param_lr_factors())
    state = init_train_state(model, optimizer, device=dev, pruned_loss=pruned_range > 0,
                             seed=args.seed)

    # ------------------------------------------------------------ resume
    ckptr = Checkpointer(out_dir / "ckpts")
    start_step, epoch, best_wer = 0, 0, float("inf")
    host_rng, data_pos = None, None
    ckpt_path = args.ckpt or (ckptr.last_checkpoint() if args.resume else None)
    if args.resume and ckpt_path is not None:
        _, _, opt_state, meta = ckptr.load_for_resume(
            ckpt_path, state.params, state.ema_params, state.opt_state)
        state = state._replace(opt_state=opt_state, step=int(meta.get("step", 0)))
        start_step = int(meta.get("step", 0))
        epoch = int(meta.get("epoch", 0))
        best_wer = float(meta.get("best_wer", float("inf")))
        host_rng = meta.get("_host_rng")
        data_pos = meta.get("_data_position")
        print(f"Resumed from {ckpt_path} at step {start_step}")
    elif args.fine_tune:
        if ckpt_path is None:
            raise ValueError("--fine_tune requires --ckpt")
        ckptr.load_for_fine_tune(ckpt_path, state.params,
                                 allow_partial=args.allow_partial_checkpoint)
        copy_tree(state.ema_params, state.params)
        print(f"Fine-tuning from {ckpt_path}")
    if world > 1:
        # every replica starts from rank 0's values, to the bit
        mesh.broadcast_tree([t for tree in (state.params, state.ema_params,
                                            state.opt_state.mu, state.opt_state.nu)
                             for _, t in tree_items(tree)])
    if model_group is not None:
        # the whole state, drawn or resumed alike everywhere, cut into shards
        state = shard_state(state, mesh.model_rank(), mp)

    # -------------------------------------------------------------- data
    mel_stats = load_mel_stats(args.mel_stats_path)
    train_fp, val_fp = build_feature_pipelines(cfg, mel_stats, device=dev)
    accum = args.grad_accumulation_batches
    micro_bs = max(args.global_batch_size // accum, 1)
    train_loader = build_data_source_loader(args, cfg, tokenizer, micro_bs, train=True,
                                            seed=args.seed)
    by_steps = hasattr(train_loader, "steps_per_epoch")  # else a tar stream's
    if by_steps and train_loader.steps_per_epoch(epoch) < accum:
        # the group of A microbatches is begun afresh each epoch: it would
        # never fill (the JAX trainer loops without a step)
        raise ValueError(
            f"an epoch holds {train_loader.steps_per_epoch(epoch)} microbatches of "
            f"{micro_bs}, fewer than --grad_accumulation_batches {accum}")
    noise_snr_sched = None
    # (the tar loader, as JAX's, adds no noise)
    background = getattr(train_loader, "background_noise", None)
    babble = getattr(train_loader, "babble_noise", None)
    if background is not None or babble is not None:
        from caiman_asr_tpu_torch.data.noise import NoiseSchedule

        noise_snr_sched = NoiseSchedule(
            args.noise_delay_steps, args.noise_ramp_steps, args.noise_initial_low,
            args.noise_initial_high, background=background[1] if background else None,
            babble=babble)
        # the loader sets each batch's SNR ranges for the step it serves,
        # in the thread that makes it
        train_loader.noise_schedule = noise_snr_sched
    # validation, the decoder and the user tokens use a tokenizer of their
    # own, without subword sampling: the train loader's thread samples from
    # the train tokenizer's stream meanwhile
    val_tokenizer = build_tokenizer(cfg, args.tokenizer_model, sampling=0.0)
    val_loader = None
    if args.val_manifests or args.val_tar_files or args.use_hugging_face:
        val_loader = build_data_source_loader(args, cfg, val_tokenizer, args.val_batch_size,
                                              train=False)

    # ------------------------------------------------------------- steps
    # user tokens resolved without subword sampling (a sampled segmentation
    # of "<EOS>" would disable the token)
    eos_idx = user_token_idx("eos", cfg.user_tokens, val_tokenizer)
    star_idx = user_token_idx("star", cfg.user_tokens, val_tokenizer)
    rsp_on = is_rsp_on(args.rsp_seq_len_freq)
    step_kw = dict(
        ema_decay=args.ema, eos_idx=eos_idx, star_idx=star_idx, eos_penalty=args.eos_penalty,
        grad_noise=cfg.grad_noise.noise_level > 0, rsp=rsp_on,
        compute_dtype=None if args.no_amp else torch.bfloat16,
        collect_layer_stats=getattr(args, "log_layer_stats", False),
        pruned_range=pruned_range, simple_loss_scale=getattr(args, "simple_loss_scale", 0.5),
        device=dev)
    if model_group is not None:
        train_step = make_train_step_tp(model, optimizer, blank_idx, data_group=group,
                                        model_group=model_group, **step_kw)
    else:
        train_step = make_train_step(model, optimizer, blank_idx, group=group, **step_kw)
    rsp_ctl, rnnt_state = None, None
    if rsp_on:
        delay = (args.rsp_delay if args.rsp_delay is not None
                 else rsp_delay_default(args.warmup_steps, args.hold_steps,
                                        args.half_life_steps))
        rsp_ctl = RSPController(args.rsp_seq_len_freq, delay, seed=args.seed)
        rnnt_state = zero_rnnt_state(model, micro_bs, device=dev)
        print(f"Random state passing on: delay={delay}, freq={args.rsp_seq_len_freq}")
        if start_step and ckpt_path is not None:
            # the carried state rides the checkpoint and the gate stream is
            # replayed, so that a resume lines up with the uninterrupted run
            rsp_ctl.fast_forward(start_step, accum)
            ex = load_extra(ckpt_path)
            rsp_leaves = [ex[k] for k in sorted((k for k in ex if k.startswith("rsp/")),
                                                key=lambda k: int(k.split("/")[1]))]
            mine = _rsp_leaves(rnnt_state)
            if rsp_leaves and len(rsp_leaves) == len(mine):
                # the global rows; this rank's are every world-th from rank
                if all(np.shape(v)[_batch_axis(t)] == t.shape[_batch_axis(t)] * world
                       for v, t in zip(rsp_leaves, mine)):
                    rnnt_state = _rsp_state_from_leaves(rnnt_state, [
                        mesh.take_rows(torch.as_tensor(np.asarray(v)), _batch_axis(t), rank,
                                       world) for v, t in zip(rsp_leaves, mine)])
                    print("Restored carried RSP state from checkpoint")
                else:
                    print("WARNING: the checkpoint's carried RSP state is of another global "
                          "batch; starting from zero state")

    def _rsp_extra():
        """The carried state in the global batch's row order (gathered from
        every rank: a collective)."""
        if not rsp_on or rnnt_state is None:
            return None
        return {f"rsp/{i}": mesh.gather_rows(leaf, _batch_axis(leaf))
                for i, leaf in enumerate(_rsp_leaves(rnnt_state))}

    # the weights validated (the EMA) and decoded for the train sample (the
    # parameters) are copied into a model of their own
    eval_model, _ = build_model(cfg, tokenizer, args, device=dev)
    eval_model.eval()
    eval_params = eval_model.param_tree()
    val_loss_step = make_val_loss_step(eval_model, blank_idx, device=dev)
    decoder = build_decoder(eval_model, blank_idx, val_tokenizer, args, cfg, eos_idx=eos_idx)

    dp_sched = build_penalty_schedule(args)
    star_sched = build_penalty_schedule(args, value_attr="star_penalty", prefix="star")
    noise_sched = (GradNoiseSchedule(cfg.grad_noise.noise_level, cfg.grad_noise.decay_const,
                                     cfg.grad_noise.start_step)
                   if cfg.grad_noise.noise_level > 0 else None)
    mel_ramp = None
    if mel_stats is not None:
        if getattr(args, "norm_use_global_stats", False):
            # dataset stats from step 0: the ramp is complete at once
            mel_ramp = MelNormRamp(-1, 0)
        else:
            mel_ramp = MelNormRamp(
                args.norm_ramp_start_step if args.norm_ramp_start_step is not None
                else args.warmup_steps,
                args.norm_ramp_end_step if args.norm_ramp_end_step is not None
                else args.warmup_steps + args.hold_steps,
                start_ratio=getattr(args, "norm_starting_ratio", 0.0))

    # -------------------------------------------------------------- loop
    profiler = Profiler(out_dir, enabled=args.profiler and lead)
    timers = PhaseTimers(out_dir if lead else None)
    resources = ResourceRecorder(out_dir, enabled=args.profiler and lead)
    profiler.start()
    resources.start()
    rng_seed = args.seed + 7
    step = start_step
    last_wer = None
    t_log = time.time()
    layer_names = None
    audio_secs_since_log = 0.0
    durs_since_log = []
    utts_since_log = 0
    print(f"Training: micro-batch {micro_bs} x accum {accum}"
          + (f" on each of {world} ranks (this one {rank})" if world > 1 else "")
          + f", on {dev}, starting at step {step}")

    restored = False
    if host_rng is not None:
        # last, so that nothing of the set-up draws from the restored streams
        if world > 1 or _per_rank(host_rng):
            saved = host_rng if _per_rank(host_rng) else [host_rng]
            host_rng = None
            if len(saved) != world:
                print(f"host random streams saved by {len(saved)} process(es), {world} now: "
                      "each rank's streams start afresh from (seed, rank)")
            else:
                host_rng = saved[rank]
        if host_rng is not None:
            try:
                train_loader.set_host_rng_state(host_rng)
                restored = True
            except ValueError as e:  # the resumed run draws from other streams
                print(f"WARNING: host random streams not restored: {e}")
    resume_batches = 0
    if start_step and by_steps:
        # the epoch and the position in it from the step count alone: a
        # checkpoint saved when a signal cut an epoch short stores epoch + 1
        spe = max(train_loader.steps_per_epoch(epoch) // accum, 1)
        epoch = start_step // spe
        resume_batches = (start_step % spe) * accum
        if restored and resume_batches == 0 and epoch > 0:
            _make_epoch_tail(train_loader, epoch - 1, accum, start_step)
    elif start_step and data_pos is not None:
        # a stream of unknown length: the position the checkpoint recorded
        epoch, resume_batches = (int(x) for x in data_pos)
    # where a stream of unknown length stands: (epoch, microbatches taken)
    position = [epoch, resume_batches]
    skip_hist: deque = deque(maxlen=SKIP_WINDOW)
    skip_warned = False
    preempted = {"flag": False, "signalled": False}

    def _on_term(signum, frame):
        if preempted["signalled"]:  # a second signal: give up at once
            raise KeyboardInterrupt
        preempted["signalled"] = True
        print(f"signal {signum}: finishing the current step, then saving "
              "the last checkpoint and exiting (resume with --resume)", flush=True)

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_term)
        except ValueError:  # not the main thread
            pass

    def save(**kw):
        """A checkpoint: the replicated state, every rank's host streams
        and the carried state gathered (collectives), written by rank 0
        while the others wait."""
        extra = _rsp_extra()
        streams = host_rng
        if world > 1:
            streams = mesh.all_gather_objects(host_rng)
            streams = streams if all(x is not None for x in streams) else None
        path = None
        whole = gather_state(state, model_group)  # a collective under --model_parallel
        if lead:
            path = ckptr.save(whole.params, whole.ema_params, whole.opt_state, epoch, step,
                              best_wer, meta=_ckpt_meta(
                                  cfg, mel_ramp, step, streams,
                                  None if by_steps else position),
                              extra=extra, **kw)
        mesh.barrier()
        return path

    while step < args.training_steps and not preempted["flag"]:
        micro_group = []
        micro_nvalid = []
        # microbatch j of the epoch's batches serves step + j // accum (the
        # loader makes it at that step's noise SNR ranges)
        steps_kw = {} if noise_snr_sched is None else {"first_step": step, "accum": accum}
        batch_iter = iter(train_loader.epoch(epoch, resume_step=resume_batches, **steps_kw))
        whole_epoch, epoch_start_step = resume_batches == 0, step
        stopped = False
        resume_batches = 0  # only the first resumed epoch is partial
        while True:
            with timers.phase("dataloading"):
                batch = next(batch_iter, None)
            if batch is None:
                if world > 1:
                    # no whole group left here: the epoch ends on every rank
                    mesh.all_reduce_ints([0, 0, 1])
                break
            host_rng = batch.host_rng
            ratio = mel_ramp.ratio(step) if mel_ramp else 0.0
            gen = derived_generator(rng_seed, step * (accum + 1) + len(micro_group), dev,
                                    data_rank)
            with timers.phase("feat_proc"):
                feats, feat_lens = train_fp(torch.from_numpy(batch.audio).to(dev),
                                            torch.from_numpy(batch.audio_lens).to(dev), gen,
                                            dataset_to_utt_ratio=ratio)
            micro_group.append({"feats": feats, "feat_lens": feat_lens,
                                "txt": torch.from_numpy(batch.tokens).to(dev),
                                "txt_lens": torch.from_numpy(batch.token_lens).to(dev)})
            micro_nvalid.append(lattice_nvalid(batch.audio_lens, batch.token_lens,
                                               cfg.input_train, model.cfg))
            audio_secs_since_log += float(np.sum(batch.audio_lens)) / train_loader.sr
            durs_since_log.extend((np.asarray(batch.audio_lens) / train_loader.sr).tolist())
            utts_since_log += len(batch.audio_lens)
            if len(micro_group) < accum:
                continue

            T = U = 0
            if world > 1:
                # one shape over the ranks, as JAX's global array has; and
                # the epoch's end wherever a rank ran out
                T, U, ended = mesh.all_reduce_ints(
                    [max(m["feats"].shape[0] for m in micro_group),
                     max(m["txt"].shape[1] for m in micro_group), 0])
                if ended:
                    break
            stacked = stack_microbatches(micro_group, T, U)
            position = [epoch, position[1] + accum]
            pack_to = None
            # the pruned loss's band bounds the joint: no packing (JAX train.py:481-483)
            if pruned_range == 0 and not getattr(args, "no_lattice_packing", False):
                enc_t = -(-stacked["feats"].shape[1] // model.cfg.enc_stack_time_factor)
                dense_n = stacked["feats"].shape[2] * enc_t * (stacked["txt"].shape[2] + 1)
                pack_to = pack_cap(max(micro_nvalid), dense_n)
            micro_group = []
            micro_nvalid = []
            scalars = {
                "delay_penalty": dp_sched.step(step, hints={"wer": last_wer}),
                "star_penalty": star_sched.step(step, hints={"wer": last_wer}),
                "grad_noise_std": noise_sched.std(step) if noise_sched else 0.0,
            }
            gen = derived_generator(rng_seed, step * (accum + 1) + accum, dev, data_rank)
            noise_gen = None
            if world > 1:  # the same noise on every rank
                noise_gen = torch.Generator(device=dev).manual_seed(
                    derived_seed(rng_seed, step * (accum + 1) + accum, NOISE_TAG))
            with timers.phase("fwd_bwd"):
                if rsp_on:
                    gates = rsp_ctl.gates(step, accum)
                    state, metrics, rnnt_state = train_step(
                        state, stacked, gen, scalars, rnnt_state, gates, pack_to=pack_to,
                        noise_generator=noise_gen)
                    if metrics["skipped"]:
                        rsp_ctl.reset()
                else:
                    state, metrics = train_step(state, stacked, gen, scalars, pack_to=pack_to,
                                                noise_generator=noise_gen)
            step += 1
            # a signal seen by any rank stops every rank after this step
            preempted["flag"] = bool(mesh.all_reduce_ints([preempted["signalled"]])[0])
            if args.profiler and step % args.timings_frequency == 0:
                timers.dump(step)

            skip_hist.append(metrics["skipped"])
            if step % args.log_frequency == 0 and len(skip_hist) >= SKIP_WINDOW // 2:
                rate = float(np.mean(skip_hist))
                if rate >= 0.5 and not skip_warned:
                    logger.log((epoch, step), {"skipped_rate_alert": rate}, subset="train")
                    print(f"WARNING: {rate:.0%} of the last {len(skip_hist)} steps were "
                          "skipped (non-finite loss). Systematic joint-logit overflow or data "
                          "corruption: training is NOT updating.", flush=True)
                    skip_warned = True
                elif rate < 0.25:
                    skip_warned = False
                if len(skip_hist) == skip_hist.maxlen and rate == 1.0:
                    raise RuntimeError(
                        f"every one of the last {skip_hist.maxlen} steps was skipped "
                        "(non-finite loss): aborting a stalled run")

            logger.accumulate({"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                               "skipped": metrics["skipped"]})
            if step % args.log_frequency == 0:
                dt = time.time() - t_log
                # the global batch's audio
                secs, utts = mesh.all_reduce_floats([audio_secs_since_log, utts_since_log])
                tput = {"audio_s_per_s": secs / dt, "utts_per_s": utts / dt}
                if durs_since_log:
                    d = np.asarray(durs_since_log)
                    tput.update(seq_len_mean_s=float(d.mean()), seq_len_max_s=float(d.max()))
                    if getattr(args, "log_verbose_utterance_statistics", False):
                        tput.update(
                            seq_len_min_s=float(d.min()),
                            seq_len_p50_s=float(np.percentile(d, 50)),
                            seq_len_p90_s=float(np.percentile(d, 90)),
                            seq_len_p99_s=float(np.percentile(d, 99)),
                            seq_len_std_s=float(d.std()))
                logger.accumulate(tput)
                logger.flush_accumulated((epoch, step))
                if "layer_stats" in metrics:
                    from caiman_asr_tpu_torch.log.layer_stats import (
                        layer_stat_names,
                        layer_stats_dict,
                    )

                    if layer_names is None:
                        layer_names = layer_stat_names(state.params)
                    logger.log((epoch, step), layer_stats_dict(layer_names,
                                                               metrics["layer_stats"]),
                               subset="train_layers")
                t_log, audio_secs_since_log, utts_since_log = time.time(), 0.0, 0
                durs_since_log = []

            if step % args.prediction_frequency == 0:
                whole = gather_tree(state.params, model_group)  # a collective
            if step % args.prediction_frequency == 0 and lead:
                copy_tree(eval_params, whole)
                _log_train_sample(logger, decoder, batch, train_fp, val_tokenizer,
                                  normalize_config_from(cfg.input_train), epoch, step, dev)

            if val_loader is not None and step % args.val_frequency == 0:
                # the EMA with its vocab shards gathered
                copy_tree(eval_params, gather_tree(state.ema_params, model_group))
                result = evaluate(
                    eval_model, decoder, val_loader, val_fp, val_tokenizer,
                    val_loss_fn=None if args.skip_val_loss else val_loss_step,
                    standardize_wer=cfg.input_val.dataset.standardize_wer,
                    normalize_config=normalize_config_from(cfg.input_val),
                    charset=list(cfg.tokenizer.labels),
                    dump_preds_dir=(out_dir / "preds") if args.dump_preds else None,
                    epoch=epoch, step=step, subset="dev_ema", logger=logger)
                last_wer = result.wer
                if args.die_if_wer_bad and step >= 10000 and result.wer > 0.99:
                    raise RuntimeError(f"dev WER {result.wer:.2%} at step {step}")
                if result.wer < best_wer:  # alike on every rank
                    best_wer = result.wer
                    best_path = save(is_best=True)
                    if lead:
                        _maybe_export_serving_bundle(best_path, args, out_dir)

            if step % args.save_frequency == 0:
                save()
            if step >= args.training_steps or preempted["flag"]:
                stopped = True
                break
        if not stopped:  # the epoch's end
            if step == epoch_start_step and whole_epoch:
                # a stream shorter than a step (with manifests refused above)
                raise ValueError(f"an epoch made no step: this rank's share holds fewer than "
                                 f"--grad_accumulation_batches {accum} microbatches of "
                                 f"{micro_bs}")
            position = [epoch + 1, 0]
        epoch += 1

    for sig, h in prev_handlers.items():
        signal.signal(sig, h)
    if preempted["flag"]:
        print(f"preempted at step {step}; saving last checkpoint", flush=True)
    if not getattr(args, "dont_save_at_the_end", False):
        save(is_last=True)
    profiler.stop()
    resources.stop()
    timers.dump(step)
    print(f"Training done at step {step}; best dev WER {best_wer:.2%}")
    logger.close()
    if joined:
        mesh.shutdown()
    return state, best_wer


def _maybe_export_serving_bundle(ckpt_path, args, out_dir):
    """Write ``serving_bundle.npz`` beside the checkpoints for a best
    checkpoint when the gates pass (reference export/checkpointer.py:106-140);
    a gate that refuses is printed, not raised."""
    from caiman_asr_tpu_torch.export.serving_bundle import create_serving_bundle

    try:
        out = create_serving_bundle(ckpt_path, args.model_config,
                                    Path(out_dir) / "serving_bundle.npz",
                                    mel_stats_path=args.mel_stats_path,
                                    skip_state_dict_check=args.skip_state_dict_check)
        print(f"exported serving bundle {out}")
    except Exception as e:  # the gates: an incomplete ramp, an unsupported schema
        print(f"serving bundle not exported: {e}")


def _ckpt_meta(cfg, mel_ramp, step, host_rng=None, data_position=None):
    """The checkpoint's meta; ``_host_rng`` holds the host random streams
    (over several processes a list a rank), ``_data_position`` the epoch and
    the microbatches taken of it, for a stream of unknown length."""
    meta = {
        "tokenizer_kw": {"labels": list(cfg.tokenizer.labels),
                         "sampling": cfg.tokenizer.sampling},
        "logmel_norm_weight": mel_ramp.ratio(step) if mel_ramp else 0.0,
    }
    if host_rng is not None:
        meta["_host_rng"] = host_rng
    if data_position is not None:
        meta["_data_position"] = data_position
    return meta


def _log_train_sample(logger, decoder, batch, fp, tokenizer, norm_cfg, epoch, step, device):
    """Decode the current train batch with the decoder (over the weights
    the caller put in its model) and log its WER (reference
    train.py:313-332): the train pipeline at its defaults, generator seed 0,
    per-utterance normalisation."""
    from caiman_asr_tpu_torch.data.text.normalize import normalize_transcript
    from caiman_asr_tpu_torch.decoding.response import frame_responses_to_tokens
    from caiman_asr_tpu_torch.evaluate.wer import word_error_rate

    with torch.inference_mode():
        feats, feat_lens = fp(torch.from_numpy(batch.audio).to(device),
                              torch.from_numpy(batch.audio_lens).to(device),
                              torch.Generator(device=device).manual_seed(0))
        responses = decoder.decode(feats, feat_lens)
    hyps = [tokenizer.detokenize(frame_responses_to_tokens(r)) for r in responses]
    refs = [normalize_transcript(t, tokenizer.charset, norm_cfg) for t in batch.transcripts]
    res = word_error_rate(hyps, refs, standardize=True)
    logger.log((epoch, step), {"train_wer": res.wer * 100.0}, subset="train")


if __name__ == "__main__":
    main()
