"""The program's span and counter recorder (``train/profiling.py``) and the
``ps.*`` spans of the corpus path (``inference/pipeline.py``,
``ops/cuda_cc.py``), on the CPU.

Off, a span is the shared null context: nothing is recorded and no
profiler range opens.  On, spans nest per thread (parent ids, inherited
units), the ring keeps its bound under three writing threads, and each
span's ``perf_counter`` interval holds its ``record_function`` event once
the profiler's times are mapped through one mark (as the benchmark's
``tracing.Profile`` maps them), within 0.5 ms."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.train import profiling
from page_segmentation_tpu_torch.train.profiling import count, counters, span, spans

PAGE = (400, 296)
SCALE = 6 / 50
RUN_SPANS = ("ps.prep", "ps.decimate", "ps.wait_prep", "ps.launch", "ps.forward", "ps.vote",
             "ps.finish", "ps.wait_download", "ps.trio")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    profiling.disable_spans()
    yield
    profiling.disable_spans()


@pytest.fixture(scope="module")
def pages():
    rng = np.random.default_rng(4)
    pages = rng.integers(0, 255, (2,) + PAGE).astype(np.uint8)
    return pages, np.where(pages < 128, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def predictor():
    module = FCNSkip(3)
    module.load_state_dict(params_from_jax(init_params_numpy(3, seed=0)))
    return ThroughputPredictor(module, None, DEFAULT_IMAGE_MAP.palette, PAGE, SCALE,
                               compute_dtype=torch.float32, download="packed",
                               cc_vote="pallas", device="cpu")


def _run(tp, pages):
    return [tuple(a.copy() for a in trio) for trio in tp.run(*pages, batch_size=1)]


# ------------------------------------------------------------------- off
def test_off_records_nothing_and_opens_no_range(predictor, pages):
    profiling.enable_spans()
    profiling.disable_spans()
    assert span("ps.a") is span("ps.b", 3)  # one shared null context, nothing made per call
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=profiling._all_threads_config()) as prof:
        with span("ps.outer", 1):
            count("ps.bytes", 5)
        _run(predictor, pages)
        predictor.execute_batch(predictor.prep_batch(pages[0][:1], pages[1][:1]))
    assert spans() == [] and counters() == {}
    assert not [e.name for e in prof.events() if e.name.startswith("ps.")]


# -------------------------------------------------------------------- on
def test_nesting_parents_and_inherited_units():
    profiling.enable_spans()
    with span("a", 7):
        with span("b"):
            with span("c", 9):
                pass
    with span("d"):
        pass
    c, b, a, d = spans()
    assert [s.name for s in (a, b, c, d)] == ["a", "b", "c", "d"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id, None)
    assert (a.unit, b.unit, c.unit, d.unit) == (7, 7, 9, None)
    assert a.start <= b.start <= c.start <= c.end <= b.end <= a.end <= d.start <= d.end
    assert {s.thread for s in (a, b, c, d)} == {threading.get_ident()}
    assert len({a.id, b.id, c.id, d.id}) == 4


def test_enable_starts_a_new_recording_and_disable_keeps_it():
    profiling.enable_spans()
    with span("x"):
        count("n", 2)
    count("n", 3)
    profiling.disable_spans()
    with span("y"):
        count("n", 100)
    assert [s.name for s in spans()] == ["x"] and counters() == {"n": 5}
    profiling.enable_spans()
    assert spans() == [] and counters() == {}


def test_ring_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_CAPACITY", 4)
    profiling.enable_spans()
    for i in range(10):
        with span("s", i):
            pass
    assert [s.unit for s in spans()] == [6, 7, 8, 9]


def test_three_threads_write_at_once():
    """Three threads (the pipeline's count) nest spans and add to one
    counter with a short switch interval: no span or count is lost and
    every parent is a span of the same thread and unit."""
    n = 400
    profiling.enable_spans()
    barrier = threading.Barrier(3)

    def work(k):
        barrier.wait(timeout=30)
        for i in range(n):
            with span("outer", 1000 * k + i):
                with span("inner"):
                    count("hits", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    records = spans()
    assert len(records) == 3 * 2 * n and counters() == {"hits": 3 * n}
    by_id = {s.id: s for s in records}
    assert len(by_id) == len(records)
    assert len({s.thread for s in records}) == 3
    for s in records:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert (parent.name, parent.thread, parent.unit) == ("outer", s.thread, s.unit)
            assert parent.start <= s.start <= s.end <= parent.end
        else:
            assert s.parent is None
    assert sorted(s.unit for s in records if s.name == "outer") == sorted(
        1000 * k + i for k in range(3) for i in range(n))


def test_span_interval_holds_its_profiler_event_through_a_mark():
    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("clock_mark"):
            mark = time.perf_counter()
        for i in range(5):
            with span("ps.outer", i):
                time.sleep(0.002)
                with span("ps.inner"):
                    torch.ones(64, 64).sum()
                    time.sleep(0.001)
    events = prof.events()
    mark_event = next(e for e in events if e.name == "clock_mark")
    offset = mark - mark_event.time_range.start / 1e6
    mapped = sorted((e.name, e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset)
                    for e in events if e.name.startswith("ps."))
    recorded = sorted((s.name, s.start, s.end) for s in spans())
    assert len(mapped) == len(recorded) == 10
    for (name, e0, e1), (rname, s0, s1) in zip(mapped, recorded):
        assert name == rname
        assert s0 - 5e-4 <= e0 <= e1 <= s1 + 5e-4, (name, e0 - s0, s1 - e1)


# ------------------------------------------------------- the corpus path
def test_run_spans_one_of_each_per_batch_and_the_same_trios(predictor, pages):
    want = _run(predictor, pages)
    profiling.enable_spans()
    got = _run(predictor, pages)
    profiling.disable_spans()
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)
    records = spans()
    by_id = {s.id: s for s in records}
    for index in range(2):
        mine = {}
        for s in records:
            if s.unit == index:
                assert s.name not in mine, f"two {s.name} spans for batch {index}"
                mine[s.name] = s
        assert sorted(mine) == sorted(RUN_SPANS)
        parent = {name: by_id[s.parent].name if s.parent else None for name, s in mine.items()}
        assert parent == {"ps.prep": None, "ps.decimate": "ps.prep", "ps.wait_prep": None,
                          "ps.launch": None, "ps.forward": "ps.launch", "ps.vote": "ps.launch",
                          "ps.finish": None, "ps.wait_download": "ps.finish",
                          "ps.trio": "ps.finish"}
        # three threads: prefetch, the caller's (dispatch), downloader
        threads = {name: s.thread for name, s in mine.items()}
        assert threads["ps.wait_prep"] == threads["ps.launch"] == threading.get_ident()
        assert len({threads["ps.prep"], threads["ps.launch"], threads["ps.finish"]}) == 3
        assert mine["ps.prep"].end <= mine["ps.wait_prep"].end <= mine["ps.launch"].start
        assert mine["ps.launch"].end <= mine["ps.finish"].start
    # pages x H x W, one byte each; one thread a call on pages this small
    assert counters() == {"ps.decimate_bytes": pages[0].size, "ps.decimate_threads": 2}


def test_decimate_threads_counted_once_per_prep_batch(predictor, pages, monkeypatch):
    """prep_batch adds the threads its decimate used to ``ps.decimate_threads``
    once a call with the recorder on, and nothing with it off."""
    from page_segmentation_tpu_torch import native

    real = native.decimate_u8

    def five_threads(p, factor, with_threads=False):
        out = real(p, factor)
        return (out, 5) if with_threads else out

    monkeypatch.setattr(native, "decimate_u8", five_threads)
    profiling.enable_spans()
    for i in range(3):
        predictor.prep_batch(pages[0][i % 2:][:1], pages[1][i % 2:][:1])
    assert counters()["ps.decimate_threads"] == 15
    assert len([s for s in spans() if s.name == "ps.decimate"]) == 3
    profiling.enable_spans()
    profiling.disable_spans()
    predictor.prep_batch(pages[0][:1], pages[1][:1])
    assert counters() == {}


def test_execute_batch_spans_carry_no_unit(predictor, pages):
    profiling.enable_spans()
    predictor.execute_batch(predictor.prep_batch(pages[0][:1], pages[1][:1]))
    records = spans()
    assert sorted(s.name for s in records) == sorted(
        ["ps.prep", "ps.decimate", "ps.launch", "ps.forward", "ps.vote", "ps.finish", "ps.wait_download",
         "ps.trio"])
    assert all(s.unit is None for s in records)


def test_trace_carries_the_span_names_and_restores_the_recorder(predictor, pages, tmp_path):
    with profiling.trace(str(tmp_path)):
        _run(predictor, pages)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(RUN_SPANS) <= names
    assert len([s for s in spans() if s.name == "ps.prep"]) == 2
    assert span("ps.after") is span("ps.other")  # off again


def test_trace_without_all_threads_keeps_the_calling_threads_spans(predictor, pages, tmp_path,
                                                                   monkeypatch):
    """On a torch whose profiler cannot record every thread, trace() still
    profiles, and the calling thread's spans reach the Chrome trace."""
    monkeypatch.setattr(profiling, "_all_threads_config", lambda: None)
    with profiling.trace(str(tmp_path)):
        _run(predictor, pages)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ps.wait_prep", "ps.launch", "ps.forward", "ps.vote"} <= names
    assert len([s for s in spans() if s.name == "ps.trio"]) == 2  # the recorder sees every thread


# --------------------------------------------------------- the train path
TRAIN_PAGE = (64, 48)
TRAIN_BATCH = 2


@pytest.fixture(scope="module")
def unet_trainer(tmp_path_factory):
    """A UNet ``Trainer`` on 4 random 64x48 pages, batch 2: two steps an epoch."""
    from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData
    from page_segmentation_tpu_torch.models.registry import Architecture
    from page_segmentation_tpu_torch.train.metrics import Monitor
    from page_segmentation_tpu_torch.train.trainer import Trainer, TrainSettings

    rng = np.random.default_rng(3)
    data = []
    for _ in range(4):
        image = rng.integers(0, 256, TRAIN_PAGE).astype(np.uint8)
        data.append(SingleData(image=image, binary=(image < 128).astype(np.uint8),
                               mask=rng.integers(0, 3, TRAIN_PAGE).astype(np.uint8)))
    settings = TrainSettings(
        n_epoch=1, n_classes=3, l_rate=1e-4, train_data=Dataset(data, DEFAULT_IMAGE_MAP),
        validation_data=None, display=10, output_dir=str(tmp_path_factory.mktemp("unet")),
        threads=1, monitor=Monitor.LOSS, architecture=Architecture.UNET,
        batch_size=TRAIN_BATCH, seed=2 ** 31 + 5, device="cpu")
    return Trainer(settings)


def test_train_with_the_recorder_off_records_nothing(unet_trainer):
    profiling.enable_spans()  # a new, empty recording
    profiling.disable_spans()
    unet_trainer.train()
    assert spans() == [] and counters() == {}


def test_one_step_span_a_step_with_its_children_under_it(unet_trainer):
    profiling.enable_spans()
    unet_trainer.train()
    profiling.disable_spans()
    records = spans()
    by_id = {s.id: s for s in records}
    steps = [s for s in records if s.name == "ps.step"]
    assert [s.unit for s in steps] == [0, 1] and all(s.parent is None for s in steps)

    def step_of(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    children = {}
    for s in records:
        if s.name == "ps.step":
            continue
        top = step_of(s)
        assert top.name == "ps.step" and top.unit == s.unit, s
        assert top.start <= s.start <= s.end <= top.end
        children.setdefault(s.unit, []).append(s.name)
    # ps.optim twice: the update and the new weights, then their copy into the module
    for unit in (0, 1):
        assert sorted(children[unit]) == sorted(["ps.batch_wait", "ps.fwd_bwd", "ps.optim",
                                                 "ps.optim", "ps.dropout", "ps.dropout"])
    parents = {s.name: by_id[s.parent].name for s in records if s.parent is not None}
    assert parents == {"ps.batch_wait": "ps.step", "ps.fwd_bwd": "ps.step", "ps.optim": "ps.step",
                       "ps.dropout": "ps.fwd_bwd"}


def test_dropout_bytes_count_a_unet_steps_formula(unet_trainer):
    from benchmark import train_arith

    profiling.enable_spans()
    unet_trainer.train()
    profiling.disable_spans()
    assert counters() == {"ps.dropout_bytes": 2 * train_arith.dropout_bytes(
        "unet", TRAIN_BATCH, TRAIN_PAGE)}


def test_request_stop_ends_the_loop_between_steps_without_a_sync(unet_trainer, monkeypatch):
    """A stop asked for inside the first step ends the loop before the
    second; no tensor is read on the host from the first step until the
    epoch's end reads the means."""
    from page_segmentation_tpu_torch.train import trainer as trainer_module

    t = unet_trainer
    inner, calls, reads, state = t._train_step, [], [], {"loop": False}

    def step(*args):
        state["loop"] = True
        calls.append(1)
        out = inner(*args)
        t.request_stop()
        return out

    def epoch_end(*args, real=trainer_module._weighted_means):
        state["loop"] = False
        return real(*args)

    def reading(name, real):
        def wrapped(*args, **kwargs):
            reads.append((name, state["loop"]))
            return real(*args, **kwargs)
        return wrapped

    for name in ("item", "tolist", "numpy", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, reading(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize", reading("synchronize", lambda *a: None))
    monkeypatch.setattr(trainer_module, "_weighted_means", epoch_end)
    monkeypatch.setattr(t, "_train_step", step)
    t.train()
    assert len(calls) == 1 and t.timings[-1]["pages"] == TRAIN_BATCH
    assert [name for name, in_loop in reads if in_loop] == []
    assert ("__float__", False) in reads  # the epoch's means, read after the loop
    monkeypatch.setattr(t, "_train_step", inner)
    t.train()  # the next call starts with the flag down
    assert t.timings[-1]["pages"] == 2 * TRAIN_BATCH
