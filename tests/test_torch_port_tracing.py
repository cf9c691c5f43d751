"""The port's span-and-counter registry (``utils/tracing.py``) on the CPU.

Off, ``span`` is one shared no-op and a tiny render records nothing. On, a
tiny render of the ``default`` bundle (24x32, 3 sources, 8 samples, tiles of
256 rays) on the fast (quad) and exact presets gives the span tree the
renderer documents, one ``gnt.sample`` and ``gnt.kernel`` per tile and the
view's seven ``sync`` spans, with the same ``combined_rgb`` bit for bit as
untraced. Self time is duration less children; ``reset`` forgets and a
summary taken before stays as it was; under ``profile_trace`` the main
thread's spans show and a worker's do not; the loader counts the items it
had ready; ``Evaluator.run`` over a tiny NVIDIA-layout scene
(``chip_smoke.write_reader_scene``) gives one ``eval.item`` root per item;
``run eval --trace-dir`` writes ``spans.json``; ``load_library`` records
its span and counter with the registry off; sixteen threads lose no span
or count. ``profile_trace`` writes a Chrome trace of the enclosed torch
ops."""

import json
import threading
import time

import pytest
import torch

import chip_smoke
from pgdvs_tpu_torch import run as trun
from pgdvs_tpu_torch.configs.benchmarks import resolve_benchmark
from pgdvs_tpu_torch.data.loader import PrefetchLoader
from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
from pgdvs_tpu_torch.data.synthetic import make_contract_data
from pgdvs_tpu_torch.engines.evaluator import Evaluator
from pgdvs_tpu_torch.kernels import _build
from pgdvs_tpu_torch.renderers.compose import render_novel_view
from pgdvs_tpu_torch.renderers.static_gnt import init_gnt_models
from pgdvs_tpu_torch.utils import tracing
from test_torch_port_lk import one_thread

H, W, N_SRC, S, RAY_TILE = 24, 32, 3, 8, 256
TILES = -(-H * W // RAY_TILE)
# the view's host-device syncs: the two temporal times, the K-NN's compaction
# and three valid counts, the target projection's scalar store
VIEW_SYNCS = 7
TREE = {"view": None, "static.gnt": "view", "gnt.features": "static.gnt",
        "gnt.sample": "static.gnt", "gnt.kernel": "static.gnt", "dynamic": "view",
        "dynamic.knn": "dynamic", "dynamic.splat": "dynamic"}


@pytest.fixture(autouse=True)
def fresh_registry():
    """An empty registry, off, and one torch thread (the tiny renders are
    many small ops, which parallel test workers would oversubscribe)."""
    tracing.disable()
    tracing.reset()
    with one_thread():
        yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def models():
    return init_gnt_models(device="cpu", feat_ch=32)


@pytest.fixture(scope="module")
def view_data():
    data = make_contract_data(h=H, w=W, n_spatial=N_SRC, n_frames=6)
    return {k: torch.as_tensor(v) if not isinstance(v, (dict, str)) else v
            for k, v in data.items()}


def _cfg(preset):
    return resolve_benchmark("default", preset=preset)[0].replace(
        n_coarse_samples_per_ray=S, ray_tile=RAY_TILE)


def _render(models, data, preset):
    return render_novel_view(models, data, _cfg(preset), noise=torch.zeros(H, W, 3))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_scene")
    chip_smoke.write_reader_scene(root, raw_hw=(H, W), eval_hw=(H, W), n_frames=3, items=(),
                                  flow_frames=((0, 3),))
    return root


def _dataset(root):
    return NvidiaEvalDataset(root, scene_ids=[chip_smoke.READER_SCENE], tgt_height=H,
                             n_src_views_spatial=2)


def _empty(summary):
    return summary == {"spans": {}, "counters": {}, "roots": {}}


def test_off_is_one_shared_no_op_and_records_nothing(models, view_data):
    assert not tracing.enabled()
    assert tracing.span("view", device=torch.device("cuda"), root_id=3) is tracing.NO_SPAN
    assert tracing.span("sync") is tracing.NO_SPAN
    _render(models, view_data, "fast")
    tracing.count("loader.items")
    assert _empty(tracing.summary())


@pytest.mark.parametrize("preset,sampler", [("fast", "quad"), ("exact", "exact")])
def test_render_span_tree(models, view_data, preset, sampler):
    assert _cfg(preset).epipolar_mode == sampler
    tracing.enable()
    _render(models, view_data, preset)
    s = tracing.summary()
    spans = s["spans"]
    assert set(TREE) <= set(spans), sorted(spans)
    for name, parent in TREE.items():
        assert spans[name]["parents"] == {parent: spans[name]["count"]}, name
    assert spans["gnt.sample"]["count"] == spans["gnt.kernel"]["count"] == TILES
    assert all(spans[n]["count"] == 1 for n in TREE if not n.startswith("gnt.s")
               and n != "gnt.kernel")
    view = s["roots"]["view"]
    assert view["count"] == 1 and len(view["records"]) == 1
    assert view["records"][0][1] == spans["view"]["host_ms"]
    assert view["within"]["sync"]["count"] == spans["sync"]["count"] == VIEW_SYNCS
    assert spans["sync"]["parents"] == {"dynamic": 3, "dynamic.knn": 4}
    assert all(t["device_ms"] is None for t in spans.values())  # on the CPU


def test_combined_rgb_bit_identical_traced_and_untraced(models, view_data):
    off = _render(models, view_data, "fast")
    tracing.enable()
    on = _render(models, view_data, "fast")
    assert not _empty(tracing.summary())
    for k in ("combined_rgb", "static_coarse_rgb", "static_coarse_depth", "render_dyn_mask"):
        assert torch.equal(off[k], on[k]), k


def test_self_time_is_duration_less_children():
    tracing.enable()
    with tracing.span("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with tracing.span("inner"):
                time.sleep(0.003)
                with tracing.span("leaf"):
                    time.sleep(0.001)
    spans = tracing.summary()["spans"]
    outer, inner, leaf = spans["outer"], spans["inner"], spans["leaf"]
    assert outer["self_host_ms"] == pytest.approx(outer["host_ms"] - inner["host_ms"],
                                                  abs=1e-9)
    assert inner["self_host_ms"] == pytest.approx(inner["host_ms"] - leaf["host_ms"],
                                                  abs=1e-9)
    assert leaf["self_host_ms"] == leaf["host_ms"] >= 2.0
    assert outer["self_host_ms"] >= 2.0 and inner["self_host_ms"] >= 6.0
    assert (inner["count"], inner["parent"], leaf["parent"]) == (2, "outer", "inner")


def test_reset_forgets_and_a_summary_stays(models, view_data):
    tracing.enable()
    _render(models, view_data, "fast")
    tracing.count("loader.items", 3)
    before = tracing.summary()
    kept = json.dumps(before, default=str)
    with tracing.span("eval.item", root_id=7):
        tracing.reset()
        with tracing.span("sync"):
            pass
    after = tracing.summary()
    assert json.dumps(before, default=str) == kept
    assert before["counters"] == {"loader.items": 3} and before["roots"]["view"]["count"] == 1
    # the root opened before the reset is not recorded; its child after it is
    assert list(after["spans"]) == ["sync"] and after["roots"] == {}
    assert after["counters"] == {}


def test_profile_trace_shows_main_thread_spans_only(models, view_data, scene, tmp_path):
    tracing.enable()
    ds = _dataset(scene)
    with tracing.profile_trace(tmp_path / "prof"):
        worker = threading.Thread(target=ds.__getitem__, args=(0,))
        worker.start()
        _render(models, view_data, "fast")
        worker.join(30.0)
    assert not worker.is_alive()
    trace = json.loads((tmp_path / "prof" / tracing.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"view", "static.gnt", "gnt.kernel", "dynamic.knn"} <= names
    assert "reader.item" not in names
    reader = tracing.summary()["spans"]["reader.item"]
    assert reader["count"] == 1 and reader["parent"] is None


def test_loader_counts_the_items_it_had_ready():
    go = threading.Event()

    class Items:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            if i == 0:
                go.wait(5.0)
            return i

    tracing.enable()
    timer = threading.Timer(0.1, go.set)
    timer.start()
    got = []
    for item in PrefetchLoader(Items(), n_workers=2, lookahead=2):
        got.append(item)
        time.sleep(0.2)  # item 1 is done before it is asked for
    timer.join(5.0)
    s = tracing.summary()
    assert got == [0, 1]
    assert s["counters"] == {"loader.items": 2, "loader.ready": 1}
    wait = s["spans"]["loader.wait"]
    assert wait["count"] == 2 and wait["host_ms"] >= 50.0


def test_evaluator_run_gives_one_eval_item_root_per_item(models, scene):
    tracing.enable()
    ev = Evaluator(models, _cfg("fast"), device="cpu")
    res = ev.run(_dataset(scene), max_items=2)
    s = tracing.summary()
    item = s["roots"]["eval.item"]
    assert res["count"] == item["count"] == 2
    assert [r[0] for r in item["records"]] == [0, 1]
    assert item["within"]["view"]["count"] == item["within"]["eval.score"]["count"] == 2
    assert s["spans"]["view"]["parents"] == {"eval.item": 2}
    assert s["spans"]["eval.score"]["parents"] == {"eval.item": 2}
    assert s["counters"]["loader.items"] == 2
    # the view's syncs, the render's copy back and the target read on the host
    assert item["within"]["sync"]["count"] == 2 * (VIEW_SYNCS + 2)


def test_trace_dir_writes_spans_json(scene, tmp_path):
    argv = ["eval", "--device", "cpu", "--data-root", str(scene),
            "--scene-ids", chip_smoke.READER_SCENE,
            "--dataset-arg", f"tgt_height={H}", "n_src_views_spatial=2",
            "--render-cfg", f"n_coarse_samples_per_ray={S}", f"ray_tile={RAY_TILE}",
            "--max-items", "1", "--trace-dir", str(tmp_path / "trace")]
    result = trun.main(argv)
    s = json.loads((tmp_path / "trace" / tracing.SUMMARY_FILE).read_text())
    assert result["count"] == 1
    assert s["roots"]["eval.item"]["count"] == 1 and s["spans"]["view"]["count"] == 1
    assert {"reader.item", "loader.wait", "eval.score", "gnt.kernel"} <= set(s["spans"])
    assert not tracing.enabled()


def test_load_library_records_its_span_and_counter_when_off(monkeypatch):
    class Lib:
        built = True

    monkeypatch.setattr(_build, "_load_library", Lib)
    assert not tracing.enabled()
    assert _build.load_library.__wrapped__().built
    s = tracing.summary()
    assert s["counters"] == {"kernels.built": 1}
    assert s["spans"]["setup.kernels"]["count"] == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tracing.profile_trace(tmp_path / "trace") as prof:
        y = (x @ x).relu().sum()
    assert torch.isfinite(y)
    trace = json.loads((tmp_path / "trace" / tracing.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert any("mm" in e.key for e in prof.key_averages())


def test_threads_lose_no_span_or_count():
    import sys

    tracing.enable()
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with tracing.span("reader.item"):
                    tracing.count("loader.items")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = tracing.summary()
    assert s["spans"]["reader.item"]["count"] == s["counters"]["loader.items"] == n_threads * n_each
