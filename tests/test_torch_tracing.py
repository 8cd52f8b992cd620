"""The port's spans and counters (``aladin_torch/utils/profiling.py``) on the
CPU, and the benchmark's readers of them (``h100_bench/lib/spans.py``,
``h100_bench/metrics/``).

Off, a span is one shared no-op context; under ``torch.profiler`` each
layer's span is a ``user_annotation`` in the Chrome trace that encloses
the ops it launched, counters add to the traced tally only while the
profiler records, and every output is the untraced output bit for bit.
The readers return their hand-computed values on a hand-written trace.
"""

import collections
import glob
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aladin_torch.config import ExperimentConfig
from aladin_torch.eval import search as S
from aladin_torch.models.aladin import ALADIN, Batch
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.ops.kernels import alignment_kernel as ak
from aladin_torch.tasks import decode_cache as dc
from aladin_torch.tasks.captioning import BertImageCaptioner
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import make_multi_train_step
from aladin_torch.utils import profiling
from h100_bench.lib import harness, spans
from h100_bench.lib.trace import TraceView
from tests.test_torch_captioning import KW, TINY, _t, decode_case
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced(fn, tmp_path):
    """(fn's result, the Chrome trace's events, the traced counters) of one
    call of ``fn`` under the CPU profiler."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, events, profiling.counters(traced=True)


def annotations(events, name):
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]


def encloses_an_op(span, events):
    """Some aten op of the trace lies inside ``span`` by ts / dur (one clock)."""
    a, b = span["ts"], span["ts"] + span["dur"]
    return any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
               and a <= e["ts"] and e["ts"] + e["dur"] <= b for e in events)


def test_span_is_one_shared_no_op_while_nothing_records():
    a, b = profiling.span("x.one"), profiling.span("x.two")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span("x.one")
        assert on is not a and isinstance(on, torch.profiler.record_function)


def test_count_adds_to_the_traced_tally_only_while_recording():
    profiling.reset_counters()
    before = profiling.counters()["x.count"]
    profiling.count("x.count")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x.count", 3)
    profiling.count("x.count", 5)
    assert profiling.counters()["x.count"] == before + 9
    assert profiling.counters(traced=True)["x.count"] == 3
    copy = profiling.counters(traced=True)
    copy["x.count"] = 100
    assert profiling.counters(traced=True)["x.count"] == 3
    profiling.reset_counters()
    assert profiling.counters(traced=True)["x.count"] == 0
    assert profiling.counters()["x.count"] == before + 9


def test_search_spans_enclose_their_ops(tmp_path):
    gen = torch.Generator().manual_seed(3)
    corpus = S.build_corpus(torch.randn(20, 6, 16, generator=gen),
                            torch.randint(3, 7, (20,), generator=gen), device="cpu")
    queries = np.random.RandomState(4).randn(2, 9, 16).astype(np.float32)
    lens = np.array([9, 6])  # int64: the upload converts them
    kw = dict(direction="t2i", k=3, shortlist=8)
    want = S.search(corpus, queries, lens, **kw)
    got, events, _ = traced(lambda: S.search(corpus, queries, lens, **kw), tmp_path)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    for name in ("search.upload", "search.stage1", "search.rerank", "search.fetch"):
        found = annotations(events, name)
        assert len(found) == 1, name
        assert encloses_an_op(found[0], events), name


def test_cached_decoder_spans_and_host_copies(tmp_path):
    model = BertImageCaptioner(BertImgConfig(**TINY)).eval()
    inp = _t(*decode_case())
    want = dc.greedy_decode_cached(model, *inp, **KW)
    got, events, counted = traced(lambda: dc.greedy_decode_cached(model, *inp, **KW), tmp_path)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert len(annotations(events, "decode.cached")) == 1
    assert len(annotations(events, "decode.prefill")) == 1
    steps = annotations(events, "decode.step")
    assert len(steps) == KW["max_steps"]
    assert all(encloses_an_op(s, events) for s in steps)
    # no tensor built from host data a step; each step's attention reads the
    # whole cache: layers x B x (C + S) x H x Dh, K and V, f32
    assert counted["decode.host_copies"] == 0
    b, od_w = inp[0].shape
    keys = od_w + inp[2].shape[1] + KW["max_steps"] + 1
    per_step = TINY["num_hidden_layers"] * b * keys * TINY["hidden_size"] * 2 * 4
    assert counted["decode.kv_bytes"] == KW["max_steps"] * per_step


def test_bucketed_scoring_spans_and_launched_ops(tmp_path):
    gen = torch.Generator().manual_seed(5)
    n_im, r, n_cap, w, d = 3, 6, 12, 40, 8
    im, cap = torch.randn(n_im, r, d, generator=gen), torch.randn(n_cap, w, d, generator=gen)
    il = torch.tensor([6, 4, 5])
    # four captions each in the 16-, 32- and 40-slot buckets (48 capped at W 40), all in
    # one call of the packed scorer
    cl = torch.tensor([5, 20, 37] * 4)
    want = ak.mrsw_scores_bucketed(im, cap, il, cl, compute_dtype=torch.bfloat16)
    got, events, counted = traced(
        lambda: ak.mrsw_scores_bucketed(im, cap, il, cl, compute_dtype=torch.bfloat16), tmp_path)
    assert torch.equal(want, got)
    assert len(annotations(events, "mrsw.bucketed")) == 1
    assert len(annotations(events, "mrsw.call")) == 1
    # after stripping: R - 1 regions; the 4 x (2 + 17 + 34) valid words fit
    # one tile of 256 columns
    assert counted["mrsw.launched_ops"] == 2 * d * n_im * (r - 1) * 1 * 256
    assert counted["k1.launches"] == 0  # CPU tensors launch no kernel


def _tiny_state():
    cfg = ExperimentConfig.from_dict({
        "model": {"embed-size": 32, "tern-layers": 1, "dropout": 0.0},
        "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1],
                     "lr": 1e-3, "bs": 4, "grad-clip": 2.0}})
    model = ALADIN(cfg, BertImgConfig(vocab_size=97, hidden_size=32, num_hidden_layers=1,
                                      num_attention_heads=4, intermediate_size=64,
                                      max_position_embeddings=64, img_feature_dim=20,
                                      hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    model.reset_parameters(torch.Generator().manual_seed(0))
    return TrainState(cfg, model, steps_per_epoch=10)


def _tiny_batches(n, b=4, l=12, r=5):
    gen = torch.Generator().manual_seed(9)
    out = []
    for _ in range(n):
        def ints(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

        cap_len, img_len = ints(5, l + 1, (b,)), ints(2, r + 1, (b,))
        pl, pr = torch.arange(l)[None], torch.arange(r)[None]
        out.append(Batch(
            txt_ids=ints(3, 97, (b, l)), txt_mask=(pl < cap_len[:, None]).int(),
            txt_type=torch.zeros(b, l, dtype=torch.int32), cap_len=cap_len,
            img_ids=ints(3, 97, (b, l)),
            img_mask=torch.cat([(pl < 5).expand(b, l), pr < img_len[:, None]], dim=1).int(),
            img_type=torch.ones(b, l, dtype=torch.int32),
            img_feats=torch.randn(b, r, 20, generator=gen), img_len=img_len))
    return out


def test_eager_window_span_and_step_count(tmp_path):
    batches = _tiny_batches(3)
    plain, spanned = _tiny_state(), _tiny_state()
    want = make_multi_train_step(plain.model, plain.cfg, k=3)(plain, batches, 0)
    multi = make_multi_train_step(spanned.model, spanned.cfg, k=3)
    got, events, counted = traced(lambda: multi(spanned, batches, 0), tmp_path)
    for name, v in want.items():
        assert torch.equal(v, got[name]), name
    for p, q in zip(plain.trainable, spanned.trainable):
        assert torch.equal(p, q)
    found = annotations(events, "step.eager")
    assert len(found) == 1 and encloses_an_op(found[0], events)
    assert counted["step.eager_steps"] == 3 and counted["step.captures"] == 0


SPAN_CALL = re.compile(r"\bspan\(\s*\"([^\"]+)\"")


def _names(paths):
    out = set()
    for p in paths:
        with open(p) as f:
            out |= set(SPAN_CALL.findall(f.read()))
    return out


def test_program_spans_differ_from_the_benchmarks():
    program = _names(glob.glob(os.path.join(ROOT, "aladin_torch", "**", "*.py"), recursive=True))
    bench = _names(glob.glob(os.path.join(ROOT, "h100_bench", "runners", "*.py")))
    with open(os.path.join(ROOT, "h100_bench", "lib", "trace.py")) as f:
        bench |= set(re.findall(r"WINDOW_SPAN = \"([^\"]+)\"", f.read()))
    assert {"bench.window", "train.window", "score.scores", "search.query"} <= bench
    read = {"step.fill", "step.replay", "decode.step", "decode.cached", "mrsw.bucketed",
            "mrsw.call", "search.stage1", "search.rerank"}
    assert read <= program
    assert not program & bench, program & bench


# the hand-written trace: times in us, the window [0, 1000]
def _view(spans_us, ops_us):
    events = [{"cat": "user_annotation", "name": "bench.window", "ts": 0.0, "dur": 1000.0},
              {"cat": "kernel", "name": "void spin_kernel(long)", "ts": -50.0, "dur": 10.0}]
    events += [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
               for n, a, b in spans_us]
    events += [{"cat": "kernel", "name": n, "ts": a, "dur": b - a} for n, a, b in ops_us]
    return TraceView(events)


def _read(metric, view, counters=None):
    res = harness.Result(setup_s=0.0, window_s=view.window_s if view else 0.0, units=1, items=1,
                         latencies_s=[], counters=counters or {}, view=view)
    return harness.load_reader(ROOT, metric)(res)


TRAIN = _view([("train.window", 50, 400), ("step.fill", 60, 150), ("step.replay", 150, 250),
               ("step.metrics", 250, 260), ("train.window", 870, 950), ("step.fill", 880, 920),
               ("step.replay", 920, 940), ("step.metrics", 940, 945)],
              [("gemm", 0, 100), ("adam", 300, 900)])  # idle: [100, 300] and [900, 1000]


def test_span_helpers_on_nested_spans():
    view = _view([("mrsw.bucketed", 100, 600), ("mrsw.call", 150, 250), ("mrsw.call", 300, 450),
                  ("inner", 320, 340), ("mrsw.bucketed", 700, 800), ("mrsw.call", 710, 790)],
                 [("k1", 0, 120), ("k1", 200, 1000)])  # idle: [120, 200]
    assert spans.self_seconds(view, "mrsw.bucketed") == pytest.approx([250e-6, 20e-6])
    # nested spans count their idle time once: [120, 200] lies in the outer
    # span and partly in a call
    assert spans.idle_seconds(view, "mrsw.") == pytest.approx(80e-6)
    assert spans.idle_seconds(view, "mrsw.call") == pytest.approx(50e-6)
    assert spans.idle_seconds(view, "none.") == 0.0
    # step.* spans: [60, 260] and [880, 945] against the gaps [100, 300], [900, 1000]
    assert spans.idle_seconds(TRAIN, "step.") == pytest.approx(205e-6)


def test_train_and_score_readers():
    assert _read("train.fill_ms", TRAIN) == pytest.approx(0.065)
    assert _read("train.step_idle_ms", TRAIN) == pytest.approx(0.1025)
    view = _view([("score.scores", 50, 950), ("mrsw.bucketed", 100, 600),
                  ("mrsw.call", 150, 250), ("mrsw.call", 300, 450),
                  ("mrsw.bucketed", 700, 800), ("mrsw.call", 710, 790)], [("k1", 0, 1000)])
    assert _read("score.bucket_host_ms", view) == pytest.approx(0.135)


@pytest.fixture
def program_counters(monkeypatch):
    """Stand the program's traced tally in with the given counts."""
    def use(**counts):
        c = collections.Counter({k.replace("__", "."): v for k, v in counts.items()})
        monkeypatch.setattr(profiling, "counters", lambda traced=False: collections.Counter(c))
    return use


def test_counter_readers(program_counters, monkeypatch):
    caption = _view([("decode.cached", 10, 400), ("decode.step", 20, 30), ("decode.step", 40, 60),
                     ("decode.step", 70, 80), ("decode.cached", 500, 900)], [("gemm", 0, 1000)])
    score = _view([("mrsw.bucketed", 10, 400), ("mrsw.bucketed", 500, 900)], [("k1", 0, 1000)])
    program_counters(decode__host_copies=78, mrsw__launched_ops=1500)
    assert _read("caption.host_copies", caption) == pytest.approx(39.0)
    assert _read("caption.step_host_ms", caption) == pytest.approx(0.010)
    assert _read("score.k1_useful_share", score,
                 {"valid_ops_per_call": 600.0}) == pytest.approx(80.0)
    program_counters(decode__host_copies=0)
    assert _read("caption.host_copies", caption) == 0.0  # a copy-free decoder reads 0
    monkeypatch.delattr(profiling, "counters")  # a program without counters: nothing to read
    assert _read("caption.host_copies", caption) is None
    assert _read("score.k1_useful_share", score, {"valid_ops_per_call": 600.0}) is None


def test_search_readers_and_missing_spans():
    view = _view([("search.query", 0, 100), ("search.stage1", 10, 20), ("search.rerank", 20, 60),
                  ("search.query", 200, 300), ("search.stage1", 210, 240),
                  ("search.rerank", 240, 260), ("search.query", 400, 500),
                  ("search.stage1", 410, 430), ("search.rerank", 430, 480)], [("mm", 0, 10)])
    assert _read("search.stage1_ms", view) == pytest.approx(0.020)
    assert _read("search.rerank_ms", view) == pytest.approx(0.040)
    # a parent's trace, with the runners' spans alone: every new reader is silent
    bare = _view([("search.query", 0, 100), ("train.window", 100, 200)], [("mm", 0, 10)])
    for metric in ("train.fill_ms", "train.step_idle_ms", "caption.step_host_ms",
                   "caption.host_copies", "score.bucket_host_ms", "score.k1_useful_share",
                   "search.stage1_ms", "search.rerank_ms"):
        assert _read(metric, bare, {"valid_ops_per_call": 1.0}) is None, metric
        assert _read(metric, None) is None, metric
