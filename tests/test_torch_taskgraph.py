"""The port's task-DAG scheduler against the JAX package's.

`dmosopt_tpu_torch.parallel.taskgraph` is a copy of
`dmosopt_tpu.parallel.taskgraph` over the port's `span_scope`. The same
graphs go through both: results, node states, skips, the serial path's
execution order and the telemetry each run emits must be equal. The
service's use of the graph (concurrency 1 equals lockstep, concurrency 2
equals it tenant by tenant) is held in tests/test_torch_service.py.
"""

import contextlib
import threading

import pytest

from dmosopt_tpu.parallel import taskgraph as jax_tg
from dmosopt_tpu_torch.parallel import taskgraph as torch_tg

PACKAGES = {"jax": jax_tg, "torch": torch_tg}


class _FakeTel:
    """Telemetry facade recording metric calls (names and label keys)."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __bool__(self):
        return True

    def _rec(self, kind, name, labels):
        with self._lock:
            self.calls.append((kind, name, tuple(sorted(labels.items()))))

    def inc(self, name, value=1, **labels):
        self._rec("inc", name, labels)

    def gauge(self, name, value, **labels):
        self._rec("gauge", name, {})

    def observe(self, name, value, **labels):
        self._rec("observe", name, labels)

    def event(self, kind, epoch=None, **fields):
        self._rec("event", kind, {k: None for k in fields})

    def span(self, name, **labels):
        self._rec("span", name, labels)
        return contextlib.nullcontext(None)


def _chain_with_failure(tg, order):
    """a -> (b -> e, c -> d); c raises, so d is skipped."""

    def mk(name):
        def fn():
            order.append(name)
            return name

        return fn

    def boom():
        order.append("c")
        raise RuntimeError("c failed")

    g = tg.TaskGraph("chain")
    a = g.add("a", mk("a"), kind="dispatch")
    b = g.add("b", mk("b"), deps=[a], kind="eval", tenant="t0")
    c = g.add("c", boom, deps=[a], kind="eval", tenant="t1")
    g.add("d", mk("d"), deps=[c], kind="fold", tenant="t1")
    g.add("e", mk("e"), deps=[b], kind="fold", tenant="t0")
    return g


def _diamond(tg, order):
    """root -> 4 evals -> (bad, good) buckets -> folds -> a joining
    checkpoint; the bad bucket's branch and the join are skipped."""

    def mk(name, value):
        def fn():
            order.append(name)
            return value

        return fn

    def bad():
        order.append("bad")
        raise ValueError("bucket failed")

    g = tg.TaskGraph("diamond")
    root = g.add("root", mk("root", "r"), kind="dispatch")
    evals = [
        g.add(f"eval{i}", mk(f"eval{i}", i), deps=[root], kind="eval")
        for i in range(4)
    ]
    b = g.add("bad", bad, deps=[evals[0]], kind="bucket")
    good = g.add("good", mk("good", "ok"), deps=[evals[1], evals[2]], kind="bucket")
    seq = g.add("seq", mk("seq", "s"), deps=[evals[3]], kind="seq", tenant="t3")
    dead = g.add("dead", mk("dead", "never"), deps=[b], kind="fold")
    live = g.add("live", mk("live", "alive"), deps=[good, seq], kind="fold")
    g.add("join", mk("join", "j"), deps=[dead, live], kind="checkpoint")
    return g


def _fan(tg, order):
    """a -> six b's -> c summing their results."""
    g = tg.TaskGraph("fan")
    a = g.add("a", lambda: order.append("a") or 2)
    bs = [
        g.add(f"b{i}", (lambda i=i: order.append(f"b{i}") or i * 10), deps=[a])
        for i in range(6)
    ]
    g.add("c", lambda: order.append("c") or sum(n.result for n in bs), deps=bs)
    return g


def _outcome(run):
    return [
        (n.name, n.kind, n.tenant, n.state, n.result,
         type(n.error).__name__ if n.error is not None else None)
        for n in run.nodes
    ]


def _tel_shape(tel):
    """The set of (kind, name, labels) calls; the queue-depth gauges'
    count depends on the interleaving, their names do not."""
    return sorted(set(tel.calls))


@pytest.mark.parametrize("concurrency", [1, 3])
@pytest.mark.parametrize("build", [_chain_with_failure, _diamond, _fan])
def test_graphs_match_jax(build, concurrency):
    results = {}
    for pkg, tg in PACKAGES.items():
        order, tel = [], _FakeTel()
        run = build(tg, order).run(concurrency=concurrency, telemetry=tel)
        results[pkg] = (run, order, tel)
    (jrun, jorder, jtel), (trun, torder, ttel) = results["jax"], results["torch"]
    assert _outcome(trun) == _outcome(jrun)
    assert trun.counts == jrun.counts
    assert [n.name for n in trun.failed] == [n.name for n in jrun.failed]
    assert [n.name for n in trun.skipped] == [n.name for n in jrun.skipped]
    assert trun.concurrency == jrun.concurrency == concurrency
    if concurrency == 1:
        # the serial path runs the nodes in creation order, skipping the
        # failed branch
        assert torder == jorder
    else:
        assert sorted(torder) == sorted(jorder)
    assert _tel_shape(ttel) == _tel_shape(jtel)
    d_t, d_j = trun.to_dict(), jrun.to_dict()
    assert set(d_t) == set(d_j)
    assert [{k: v for k, v in n.items() if k not in ("wait_s", "run_s")}
            for n in d_t["nodes"]] == [
        {k: v for k, v in n.items() if k not in ("wait_s", "run_s")}
        for n in d_j["nodes"]]


def test_add_rejects_forward_or_foreign_dep():
    for tg in PACKAGES.values():
        g = tg.TaskGraph("t")
        a = g.add("a", lambda: 1)
        other = tg.TaskGraph("other")
        b_other = other.add("b", lambda: 2)
        with pytest.raises(ValueError, match="topological"):
            g.add("c", lambda: 3, deps=[b_other])
        assert a.seq == b_other.seq


@pytest.mark.parametrize(
    "spec", [None, False, 0, 1, 5, -2, True, {"concurrency": 3}, {}, "4"]
)
def test_resolve_concurrency_matches_jax(spec):
    assert torch_tg.resolve_concurrency(spec) == jax_tg.resolve_concurrency(spec)


def test_pooled_stall_and_state_constants():
    """The port keeps the JAX module's state names, device kinds, and
    the stall gauge: the longest ready-wait of a device-launching node
    under a pool, 0 on the serial path."""
    for name in ("PENDING", "READY", "RUNNING", "DONE", "FAILED", "SKIPPED",
                 "DEVICE_KINDS"):
        assert getattr(torch_tg, name) == getattr(jax_tg, name), name
    for concurrency in (1, 2):
        g = torch_tg.TaskGraph("t")
        a = g.add("a", lambda: 1, kind="bucket")
        g.add("b", lambda: 2, deps=[a], kind="seq")
        run = g.run(concurrency=concurrency)
        assert run.stall_s >= 0.0
        if concurrency == 1:
            assert run.stall_s == 0.0
        assert all(n.wait_s is not None and n.run_s is not None for n in run.nodes)
