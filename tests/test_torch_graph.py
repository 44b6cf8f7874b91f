"""The decode step replayed as CUDA graphs (``engine/step_graph.py``).

On the CPU an engine captures nothing, and neither does one under a
mesh. The replay's bookkeeping — each step's inputs copied into the
graph's tensors, state the step returns out of place copied back into
the engine's — is held to the eager step on the CPU too, with a stand-in
for the graph that runs the captured function again on every replay.
The capture itself runs on the CPU over a stand-in for
``torch.cuda.CUDAGraph``: a span the traced step opens splits it into
graphs and is recorded again at every replay, and the kernels' launch
counters count each replay's launches, not the capture's.

On the card (marker ``gpu``, skipped without one) the real graphs'
committed tokens equal the same engine's eager step bit for bit over 300
and more steps: granite's MoE on the contiguous and the paged cache
(preemption included) and RWKV-6, the device and the host sampler
placement, bias rows present and absent, greedy, sampled and seeded rows,
admissions, retirements and slot reuse; replays equal the dispatched
steps past each variant's first; a hot-set swap and a placement switch
each capture the decision's graph once more. Eager is forced through the
engine's private ``_graph_device`` alone.

    PYTHONPATH=src python -m pytest tests/test_torch_graph.py
"""
import contextlib
import socket

import numpy as np
import pytest
import torch

from repro_torch.config import SamplingConfig, SHVSConfig, get_arch
from repro_torch.engine import engine as engine_mod
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.engine.request import Request
from repro_torch.engine import step_graph
from repro_torch.kernels import _build, fused_kernel, penalty_kernel
from repro_torch.models.model import Model
from repro_torch.obs import StepTracer, Telemetry
from repro_torch.obs import tracer as obs_tracer

GRANITE, RWKV = "granite-moe-1b-a400m", "rwkv6-3b"

CONTRACTS = (
    SamplingConfig(greedy=True),
    SamplingConfig(temperature=0.7, top_p=0.9, top_k=50,
                   repetition_penalty=1.1),
    SamplingConfig(temperature=1.0, min_p=0.05, presence_penalty=0.3,
                   frequency_penalty=0.3),
    SamplingConfig(temperature=0.9, seed=4321),
    SamplingConfig(temperature=1.0),
)
BIASED = SamplingConfig(temperature=0.8, top_k=20,
                        logit_bias=((3, 4.0), (7, -2.0), (11, 1.5)))


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes are tiny: one intra-op thread a test, so that the
    suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


_MODELS = {}


def _model(arch, dev):
    key = (arch, str(dev))
    if key not in _MODELS:
        cfg = get_arch(arch).reduced()
        _MODELS[key] = cfg, Model(cfg).init(seed=0, device=dev)
    return _MODELS[key]


def _requests(vocab, n, seed, max_new, bias_from=None):
    """``n`` requests of mixed contracts, prompts of 3-20 tokens and
    outputs of 2 to ``max_new`` tokens: more requests than slots, so
    rows are admitted, retire and their slots are reused. From request
    ``bias_from`` on every third one carries logit-bias rows."""
    rs = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        s = CONTRACTS[i % len(CONTRACTS)]
        if bias_from is not None and i >= bias_from and i % 3 == 0:
            s = BIASED
        reqs.append(Request(
            request_id=i, prompt=rs.integers(1, vocab,
                                             int(rs.integers(3, 21))).tolist(),
            max_new_tokens=int(rs.integers(2, max_new + 1)), sampling=s))
    return reqs


def _engine(arch, dev, *, cache="contiguous", mode="device", hot_counts=None):
    cfg, params = _model(arch, dev)
    ecfg = EngineConfig(
        max_batch=4, max_seq_len=64, algorithm="shvs",
        shvs=SHVSConfig(hot_size=128), k_cap=64, cache=cache,
        block_size=8, num_blocks=9 if cache == "paged" else 0,
        sampler_mode=mode, samplers=2)
    return Engine(cfg, params, ecfg, device=dev, hot_counts=hot_counts,
                  telemetry=Telemetry(tracer=StepTracer(capacity=1 << 16)))


class _Rerun:
    """A CUDA graph's stand-in on the CPU: the capture runs the function
    (its step's work, which a real capture leaves to the replay that
    follows it), and every later replay runs it again and writes what it
    returns into the tensors the capture returned, as a graph's replay
    writes its outputs. No tracer records in either (the real capture's
    spans are held apart, over a stand-in graph)."""

    def __init__(self, fn):
        self.fn, self.fresh = fn, True
        with obs_tracer.use(obs_tracer.NULL_TRACER):
            self.out = fn()

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        with obs_tracer.use(obs_tracer.NULL_TRACER):
            new = self.fn()
        outs = self.out if isinstance(self.out, tuple) else (self.out,)
        news = new if isinstance(new, tuple) else (new,)
        for dst, src in zip(outs, news):
            dst.copy_(src)


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Engines built in the test replay their step through :class:`_Rerun`
    on the CPU, wherever the engine's own rule allows graphs."""
    def capture(device, fn, stream):
        g = _Rerun(fn)
        return g, g.out

    monkeypatch.setattr(engine_mod, "capture", capture)

    def on(eng):
        eng._graph_device = True
        eng._capture_stream = "cpu"
        return eng
    return on


def _serve(eng, reqs, actions=None, max_steps=5000):
    """Serve ``reqs`` to the end; ``actions[i](eng)`` runs before step i.
    Returns each request's (output, finish reason) and the steps taken."""
    eng.submit(reqs)
    steps = 0
    while (eng.scheduler.has_work or eng.in_flight) and steps < max_steps:
        if actions and steps in actions:
            actions[steps](eng)
        eng.step()
        steps += 1
    eng.flush()
    assert all(r.done for r in reqs), "requests left unfinished"
    return [(list(r.output), r.finish_reason) for r in reqs], steps


def _dispatches(eng):
    """The ``graph`` attribute of every ``dispatch`` span, in order."""
    return [dict(e.args)["graph"] for e in eng.tracer.events()
            if e.kind == "dispatch"]


def _counts(eng):
    m = eng._metrics
    return int(m.graph_replays.value), int(m.graph_captures.value)


# -- on the CPU --------------------------------------------------------------


class _FakeGraph:
    """``torch.cuda.CUDAGraph``'s stand-in for :func:`step_graph.capture`
    on the CPU: notes its capture and each replay in ``log``."""

    log: list = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert pool is not None and capture_error_mode == "thread_local"
        self.open = True

    def capture_end(self):
        assert self.open
        self.open = False

    def replay(self):
        assert not self.open
        self.log.append(("replay", id(self)))


@pytest.fixture
def fake_graphs(monkeypatch):
    _FakeGraph.log = log = []
    pool = object()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: pool)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return log


def _launch(kernel, n=1):
    """What a kernel wrapper does to its counter when it launches."""
    with _build.COUNT_LOCK:
        kernel.launches += n


def _routed_step():
    """A step as the forward is one: work, a span opened through
    ``obs.tracer.current()`` (an MoE layer's routing), more work."""
    _launch(penalty_kernel)
    with obs_tracer.current().span("moe_route", device=torch.device("cpu"),
                                   pairs=16):
        _launch(fused_kernel, 2)
    _launch(penalty_kernel)
    return "out"


@pytest.mark.parametrize("traced", [True, False])
def test_capture_splits_at_spans_and_replays_them(fake_graphs, traced):
    """Traced, a span the captured function opens ends one graph and
    starts the next, and each replay opens and closes the span between
    the graphs' replays; untraced, the step is one graph and a replay
    records nothing, under an enabled tracer too. Either way the
    capture's launches are taken back from the kernels' counters and a
    replay adds them, so the counters count what ran."""
    before = (penalty_kernel.launches, fused_kernel.launches)
    with obs_tracer.use(StepTracer(enabled=traced)):
        program, out = step_graph.capture(torch.device("cpu"), _routed_step,
                                          stream=None)
    assert out == "out"
    assert (penalty_kernel.launches, fused_kernel.launches) == before
    assert dict(program.launches) == {penalty_kernel: 2, fused_kernel: 2}
    graphs = [p for p in program.parts if isinstance(p, _FakeGraph)]
    assert len(graphs) == (3 if traced else 1)
    assert len(program.parts) == (5 if traced else 1)   # + open, close
    assert fake_graphs == []                 # a capture runs nothing
    tracer = StepTracer(clock=lambda: fake_graphs.append("clock") or 0.0)
    for n in (1, 2):
        with obs_tracer.use(tracer):
            program.replay()
        assert penalty_kernel.launches == before[0] + 2 * n
        assert fused_kernel.launches == before[1] + 2 * n
    replays = [("replay", id(g)) for g in graphs]
    once = [replays[0], "clock", replays[1], "clock", replays[2]] \
        if traced else replays
    assert fake_graphs == once + once
    routes = [e for e in tracer.events() if e.kind == "moe_route"]
    assert [dict(e.args) for e in routes] == \
        ([{"pairs": 16}] * 2 if traced else [])


def test_capture_holds_off_the_garbage_collector(fake_graphs):
    """A collection during a capture could destroy another engine's
    graphs, which a capture forbids: the collector is off while the
    captured function runs, and as it was before afterwards."""
    import gc
    seen = []

    def step():
        seen.append(gc.isenabled())
        return "out"

    assert gc.isenabled()
    step_graph.capture(torch.device("cpu"), step, stream=None)
    assert seen == [False] and gc.isenabled()
    gc.disable()
    try:
        step_graph.capture(torch.device("cpu"), step, stream=None)
        assert not gc.isenabled()
    finally:
        gc.enable()


@pytest.mark.parametrize("arch,mode", [(GRANITE, "device"), (RWKV, "host")])
def test_engine_on_the_cpu_never_captures(arch, mode):
    cpu = torch.device("cpu")
    eng = _engine(arch, cpu, mode=mode)
    _serve(eng, _requests(512, 8, 1, 6))
    eng.close()
    flags = _dispatches(eng)
    assert flags and set(flags) == {0}
    assert _counts(eng) == (0, 0) and eng._graphs == {}


def test_engine_under_a_mesh_never_captures(rerun_graphs):
    """Under a (1, 1) mesh of one gloo rank the same engine, graphs
    allowed, steps eagerly; out of the mesh it captures."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import dist
    cpu = torch.device("cpu")
    eng = rerun_graphs(_engine(GRANITE, cpu))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=1, rank=0)
    try:
        with dist.use_mesh(make_local_mesh(1, 1, device_type="cpu")):
            assert not eng._graphs_on()
            _serve(eng, _requests(512, 6, 2, 5))
    finally:
        tdist.destroy_process_group()
    assert _counts(eng) == (0, 0) and set(_dispatches(eng)) == {0}
    assert eng._graphs_on()
    _serve(eng, _requests(512, 6, 3, 5))
    eng.close()
    assert _counts(eng)[1] == 2


def _equal_to_eager(dev, arch, cache, mode, n, max_new, bias_from, graphs):
    """Serve the same requests on an eager engine and on one that replays
    its step (``graphs`` makes it so: the card's own rule, or the CPU's
    stand-in); the streams must be equal, and the graphs engage on every
    dispatch past each variant's first use."""
    cfg, _ = _model(arch, dev)
    eager = _engine(arch, dev, cache=cache, mode=mode)
    eager._graph_device = False
    want, _ = _serve(eager, _requests(cfg.vocab_size, n, 7, max_new,
                                      bias_from))
    eager.close()
    eng = graphs(_engine(arch, dev, cache=cache, mode=mode))
    got, steps = _serve(eng, _requests(cfg.vocab_size, n, 7, max_new,
                                       bias_from))
    captured = {k: g is not None for k, g in eng._graphs.items()}
    eng.close()
    assert got == want
    flags = _dispatches(eng)
    replays, captures = _counts(eng)
    # each variant's first use is eager: the forward's (the first step),
    # and on the device each decision variant's (no bias rows yet, bias
    # rows; the first may serve a single step and never be captured)
    decide = [k for k in captured if k[0] == "decide"]
    if mode == "host":
        assert not decide and flags.count(0) == 1
    else:
        assert set(decide) <= {("decide", False, True),
                               ("decide", True, True)}
        assert (("decide", True, True) in captured) == \
            (bias_from is not None)
        assert flags.count(0) == len(decide)
    assert captured[("forward", True)] and replays == flags.count(1)
    assert captures == sum(captured.values())
    if cache == "paged":
        assert eng.scheduler.finished and \
            sum(r.preempt_count for r in eng.scheduler.finished) > 0
    return steps


CASES = [(GRANITE, "contiguous", "device", None),
         (GRANITE, "contiguous", "device", 4),
         (GRANITE, "paged", "device", 4),
         (GRANITE, "contiguous", "host", 4),
         (RWKV, "contiguous", "device", 4),
         (RWKV, "contiguous", "host", None)]


@pytest.mark.parametrize("arch,cache,mode,bias_from", CASES)
def test_replayed_step_equals_eager_on_the_cpu(arch, cache, mode, bias_from,
                                               rerun_graphs):
    _equal_to_eager(torch.device("cpu"), arch, cache, mode, 20, 12,
                    bias_from, rerun_graphs)


def _recaptures(dev, graphs):
    """A hot-set swap, then a switch to the host pool and back: each
    drops the decision's graph and captures it once more; the streams
    equal an eager engine's making the same moves at the same steps."""
    cfg, _ = _model(GRANITE, dev)
    counts = np.arange(cfg.vocab_size)[::-1].copy()
    actions = {6: lambda e: e._apply_hot_size(96),
               12: lambda e: e.set_sampler_mode("host"),
               16: lambda e: e.set_sampler_mode("device")}
    outs, engines = [], []
    for make in (lambda e: e, graphs):
        eng = _engine(GRANITE, dev, hot_counts=counts)
        if make is not graphs:
            eng._graph_device = False
        eng = make(eng)
        seen = {}

        def probe(k, act):
            def run(e):
                seen[k] = _counts(e)
                act(e)
            return run
        out, _ = _serve(eng, _requests(cfg.vocab_size, 14, 5, 16),
                        {k: probe(k, a) for k, a in actions.items()})
        seen["end"] = _counts(eng)
        eng.close()
        outs.append(out)
        engines.append((eng, seen))
    assert outs[0] == outs[1]
    eng, seen = engines[1]
    assert seen[6][1] == 2                  # forward + decision
    assert seen[12][1] == 3                 # the swap: the decision again
    assert seen[16][1] == 3                 # the pool needs the forward only
    assert seen["end"][1] == 4              # back on the device: once more
    flags = _dispatches(eng)
    # eager: the first step, the first after the swap, the first back on
    # the device
    assert flags.count(0) == 3


def test_hot_set_swap_and_placement_switch_recapture_once_on_the_cpu(
        rerun_graphs):
    _recaptures(torch.device("cpu"), rerun_graphs)


# -- on the card -------------------------------------------------------------


def _on_card(eng):
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cache,mode,bias_from", CASES)
def test_graphed_step_equals_eager_step_on_cuda(arch, cache, mode,
                                                bias_from):
    dev = _cuda()
    steps = _equal_to_eager(dev, arch, cache, mode, 80, 40, bias_from,
                            _on_card)
    assert steps >= 300


@pytest.mark.gpu
def test_hot_set_swap_and_placement_switch_recapture_once_on_cuda():
    _recaptures(_cuda(), _on_card)
