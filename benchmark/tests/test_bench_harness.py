"""CPU tests of the benchmark's harness at tiny sizes: the generators, the
statistics, the counts, the isolation check, finding cells and metrics by
name, the reference against the port, and the faults the check must catch.

Run from the root of the repository:

    python -m pytest benchmark/tests -q

The ``gpu``-marked test needs the card and skips without one.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cell as cell_mod, common, run  # noqa: E402
from benchmark.cell import Cell, Record, load_json  # noqa: E402
from benchmark.drivers import stream, train  # noqa: E402


def tiny_config() -> dict:
    cfg = load_json(ROOT / "benchmark/configs/base-85M.json")
    cfg["rnnt"].update(enc_n_hid=32, pred_n_hid=16, joint_n_hid=24)
    cfg["n_classes"] = 40
    cfg["batch_size"] = 4
    return cfg


def train_cell(seed: int = 1234567890123, control: str = "", follow: int = 2) -> Cell:
    traffic = dict(load_json(ROOT / "benchmark/traffic/librispeech_train.json"), recordings=4,
                   max_s=3.0, mean_s=2.0, sd_s=0.5, deck_utterances=64)
    # limits for these tiny widths (the cell's own are for its widths)
    limits = {"follow_steps": follow, "loss_gap": 1e-3, "grad_gap": 2e-2, "grad_diff": 0.2,
              "change_gap": 2e-2}
    return Cell("tiny-train", 1, tiny_config(), traffic, limits, seed, 1.0, False,
                time.perf_counter(), device="cpu", control=control)


def stream_cell(seed: int = 98765432109876, control: str = "") -> Cell:
    traffic = dict(load_json(ROOT / "benchmark/traffic/captions_paced.json"), lanes=6,
                   pool_chunks=600, recording_chunks=100, warm_ticks=2)
    limits = {"check_lanes": 3, "token_gap": 0.02}
    return Cell("tiny-stream", 1, tiny_config(), traffic, limits, seed, 0.6, False,
                time.perf_counter(), device="cpu", control=control)


# ---------------------------------------------------------------- traffic
@pytest.fixture
def one_thread():
    """The generators on one CPU thread. Under pytest a CPU worker thread now
    and then computes its share of an elementwise ``sin`` up to 1.5e-4 away
    from the others', which moves an int16 sample; on one thread the
    traffic repeats exactly, as it does on the card."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_traffic_repeats_by_seed_and_keeps_its_sizes(one_thread):
    cfg, t = tiny_config(), train_cell().traffic
    a, b = (train.Traffic(t, cfg, 7, "cpu") for _ in range(2))
    c = train.Traffic(t, cfg, 8, "cpu")
    for i in range(3):
        ma, mb = a.step(i)[0], b.step(i)[0]
        assert torch.equal(ma["audio"], mb["audio"]) and torch.equal(ma["txt"], mb["txt"])
    assert sorted(a.deck[a.order]) == sorted(c.deck[c.order])   # the same sizes
    assert not np.array_equal(a.deck[a.order], c.deck[c.order])  # in another order
    u = a.step(0)[0]["u"]
    assert (a.step(0)[0]["txt"][np.arange(4), u - 1] == train.EOS_IDX).all()


def test_stream_traffic_repeats_by_seed_and_slices_the_pool(one_thread):
    t = stream_cell().traffic
    a, b = stream.Traffic(t, 7, 5, "cpu"), stream.Traffic(t, 7, 5, "cpu")
    assert np.array_equal(a.pool, b.pool)
    parts = a.block(85)                      # rows 595..599, then 0..1 of 600
    assert [len(r) for r, _ in parts] == [5, 2]
    assert np.array_equal(parts[1][1], [5, 6])
    assert np.array_equal(parts[1][0][1], a.lane_audio(6, 86)[-960:])


# ------------------------------------------------------------- statistics
def _reader(name):
    return run.reader(name)


def test_p95_is_over_every_chunk_and_a_missing_chunk_misses():
    rec = Record()
    rec.values["chunk_latency_s"] = [0.01] * 94 + [0.02] * 5 + [float("inf")]
    assert _reader("stream_resp_p95_ms")(rec) == pytest.approx(20.0)
    rec.values["chunk_latency_s"] = [0.01] * 90 + [float("inf")] * 10
    assert _reader("stream_resp_p95_ms")(rec) == float("inf")


def test_idle_share_is_a_union_of_spans_not_a_sum():
    spans = [(0, 10), (5, 15), (20, 30), (22, 24)]
    assert common.union_ns(spans) == 25
    assert common.idle_gaps(spans, 0, 40) == [(15, 20), (30, 40)]
    rec = Record(trace={"busy_s": 25e-9, "window_s": 40e-9})
    assert _reader("idle_share.train")(rec) == pytest.approx(100 * 15 / 40)


def test_a_family_of_metrics_shares_one_reader():
    rec = Record(trace={"busy_s": 3.0, "window_s": 4.0})
    for name in ("idle_share.train", "idle_share.stream_p95", "idle_share.a_later_cell"):
        assert _reader(name)(rec) == pytest.approx(25.0)
    assert not (ROOT / "benchmark/metrics/idle_share.train.py").exists()


def test_operation_and_byte_counts_equal_hand_sums():
    assert common.lstm_flops(3, 5, 2) == 2 * 3 * (5 + 2) * 8
    rnnt = dict(in_feats=4, enc_n_hid=2, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
                enc_stack_time_factor=2, pred_n_hid=3, pred_rnn_layers=1, joint_n_hid=5)
    hand = (2 * 10 * (4 + 2) * 8 + 2 * 5 * (4 + 2) * 8 + 2 * 7 * (3 + 3) * 12
            + 2 * 5 * 2 * 5 + 2 * 7 * 3 * 5 + 2 * 20 * 5 * 11)
    assert common.model_forward_flops(rnnt, 11, 10, 5, 7, 20) == hand
    ms, what = common.recurrence_bound_ms(2, "bfloat16", B=3, H=4)
    nbytes = 2 * (4 * 16 + 2 * 3 * 16 + 2 * 2 * 3 * 4 + 2 * 3 * 4)
    assert what == "bytes" and ms == pytest.approx(1e3 * nbytes / common.HBM_BYTES_PER_S)
    ms, _ = common.joint_bound_ms(10, 4, 6)
    nbytes = (10 * 4 * 2 + 4 * 6 * 2 + 6 * 4 + 10 * 16) + (10 * 4 * 2 + 4 * 6 * 2 + 10 * 8
                                                           + 10 * 4 * 2 + 4 * 6 * 4 + 6 * 4)
    assert ms == pytest.approx(1e3 * max(nbytes / common.HBM_BYTES_PER_S,
                                         3 * 2 * 10 * 4 * 6 / common.PEAK_FLOPS["bfloat16"]))
    f = stream.tick_flops(dict(rnnt, in_feats=240, enc_pre_rnn_layers=2), 11)
    assert f["joint_row"] == 2 * 5 * 11 and f["pred_step"] == 2 * (3 + 3) * 12 + 2 * 3 * 5


def test_quantile_is_nearest_rank():
    assert common.quantile(list(range(1, 101)), 0.95) == 95
    assert common.quantile([3.0], 0.99) == 3.0


# -------------------------------------------------------------- isolation
def test_isolation_compares_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "caiman_asr_tpu_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    for name in ("jax", "jax.numpy", "jaxlib", "flax", "caiman_asr_tpu", "caiman_asr_tpu.ops"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "caiman_asr_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["caiman_asr_tpu", "jax"]


def test_a_run_of_the_harness_loads_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.drivers.train, "
            "benchmark.drivers.stream, benchmark.reference.greedy, benchmark.reference.train; "
            "import caiman_asr_tpu_torch.train, caiman_asr_tpu_torch.serving.engine; "
            "print(benchmark.run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        text = path.read_text()
        assert "caiman_asr_tpu" not in text and "import jax" not in text, path


# --------------------------------------------------------- found by name
def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    for sub in ("traffic", "limits", "metrics", "configs"):
        shutil.copytree(ROOT / "benchmark" / sub, here / sub)
    (here / "traffic" / "new_mix.json").write_text(json.dumps(dict(
        load_json(ROOT / "benchmark/traffic/captions_paced.json"), lanes=64)))
    (here / "limits" / "new-cell.json").write_text(json.dumps({"check_lanes": 2,
                                                               "token_gap": 1.0}))
    (here / "metrics" / "new_metric.py").write_text("def read(rec):\n    return 42.0\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new-cell", "config": "base-85M", "traffic": "new_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].insert(0, {"name": "stream_resp_p95_ms", "unit": "ms", "better": "lower",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["new-cell"]})
    bench["per_layer"].append({"name": "new_metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "stream_resp_p95_ms", "workloads": ["new-cell"]})
    monkeypatch.setattr(cell_mod, "HERE", here)
    monkeypatch.setattr(run, "HERE", here)
    c = cell_mod.find_cell(bench, "new-cell", seed=1, seconds=1.0, trace=True, t_start=0.0)
    assert c.traffic["lanes"] == 64 and c.limits["token_gap"] == 1.0
    names = [m["name"] for m in run.cell_metrics(bench, "new-cell", True)]
    assert names == ["new_metric"]
    assert run.reader("new_metric")(Record()) == 42.0
    assert [m["name"] for m in run.cell_metrics(bench, "new-cell", False)] == [
        "stream_resp_p95_ms", "setup_s"]


def test_every_metric_of_the_benchmark_has_a_reader_and_every_cell_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert run.reader(m["name"]) is not None, m["name"]
    for w in bench["workloads"]:
        c = cell_mod.find_cell(bench, w["name"], seed=1, seconds=1.0, trace=False, t_start=0.0)
        assert c.traffic["driver"] in ("train", "stream")


# ------------------------------------------------ the reference and faults
def test_the_reference_follows_the_port_and_its_control_reads_wider():
    rec = train.run(train_cell())
    assert run.is_correct(rec), rec.checks
    ctl = train.run(train_cell(control="fp8"))
    ratio = max(ctl.checks[f"fp8.{k}"]["value"] / max(rec.checks[k]["value"], 1e-12)
                for k in rec.checks)
    assert ratio >= 3.0, (rec.checks, ctl.checks)


def test_controls_read_together_read_as_each_alone():
    both = train.run(train_cell(control="fp8,half_batch"))
    for c in ("fp8", "half_batch"):
        alone = train.run(train_cell(control=c))
        assert alone.checks == {k: v for k, v in both.checks.items() if k.startswith(c + ".")}


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from caiman_asr_tpu_torch.training import optimizer

    def frozen(self, params, ema, state, grads, good, *a, **k):
        return state, torch.zeros(())

    monkeypatch.setattr(optimizer.Lamb, "update", frozen)
    rec = train.run(train_cell())
    assert not run.is_correct(rec)
    assert rec.checks["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from caiman_asr_tpu_torch.training import step as step_mod

    real = step_mod._micro_loss

    def half(model, params, mb, generator, mods, denom, *a, **k):
        B = mb["feats"].shape[1]
        cut = {"feats": mb["feats"][:, :B // 2], "feat_lens": mb["feat_lens"][:B // 2],
               "txt": mb["txt"][:B // 2], "txt_lens": mb["txt_lens"][:B // 2]}
        if k.get("rnnt_state") is not None:
            k["rnnt_state"] = step_mod.map_state(
                lambda t: t[:, :B // 2] if t.dim() == 3 else t[:B // 2], k["rnnt_state"])
        loss, st = real(model, params, cut, generator, mods, denom / 2, *a, **k)
        return loss, k["rnnt_state"] if st is None else step_mod.map_state(
            lambda t: torch.cat([t, t], dim=1 if t.dim() == 3 else 0), st)

    monkeypatch.setattr(step_mod, "_micro_loss", half)
    rec = train.run(train_cell())
    assert not run.is_correct(rec), rec.checks


def test_the_stream_reference_follows_the_engine():
    rec = stream.run(stream_cell())
    assert run.is_correct(rec), rec.checks
    assert rec.values["decisions_checked"] > 0 and rec.failed == 0


def test_the_stream_control_reads_wider_than_the_engine():
    rec = stream.run(stream_cell(control="fp8"))
    assert rec.checks["token_gap"]["value"] >= 3.0 * rec.values["program_gap"], rec.values


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from caiman_asr_tpu_torch.serving import engine as engine_mod

    real = engine_mod.make_streaming_step

    def altered(model, blank_idx, **kw):
        step = real(model, blank_idx, **kw)

        def wrong(params, f, dec_state):
            toks, n, st = step(params, f, dec_state)
            return torch.where(toks != blank_idx, (toks + 1) % blank_idx, toks), n, st
        return wrong

    monkeypatch.setattr(engine_mod, "make_streaming_step", altered)
    rec = stream.run(stream_cell())
    assert rec.values["tokens_checked"] > 0
    assert not run.is_correct(rec), rec.checks


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_k1_times_on_the_card(card):
    t = common.k1_times(1024, 1024, reps=3)
    assert t[2] > 0 and t[1] > 0
