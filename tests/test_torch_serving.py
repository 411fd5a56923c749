"""The port's serving runtime against the JAX package's, on the CPU.

- HealthMonitor on devices=["cpu"]: the JAX test's probe / failure /
  recovery sequence (tests/test_serving.py:128), step for step against the
  JAX monitor, its background loop, and no silent CPU default without a
  GPU;
- InferenceServer.infer: the blocking single-sample call returns the row
  of the direct batch forward, which equals the JAX forward's; warmup()
  runs every bucket (on the CPU, eagerly: nothing is captured); with
  params=, the server calls forward(params, x) and a record replaced in
  the params changes the key of its bucket graphs.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnnpack_tpu import serving as jserving
from qnnpack_tpu.models import graph as jgraph
from qnnpack_tpu_torch import serving as tserving
from qnnpack_tpu_torch.models import graph as tgraph


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def sequence(mon, events):
    """The JAX test's steps: (probe result, healthy, probes, failures,
    events) after a good probe, a probe under a zero deadline, and a good
    one again."""
    steps = []
    steps.append((mon.probe_once(), mon.healthy, mon.probes, mon.failures,
                  list(events)))
    mon._deadline_s = 0.0
    steps.append((mon.probe_once(), mon.healthy, mon.probes, mon.failures,
                  list(events)))
    steps.append((mon.probe_once(), mon.healthy, mon.probes, mon.failures,
                  list(events)))
    mon._deadline_s = 30.0
    steps.append((mon.probe_once(), mon.healthy, mon.probes, mon.failures,
                  list(events)))
    return steps


def test_health_monitor_probe_and_recovery():
    events = []
    mon = tserving.HealthMonitor(interval_s=0.05, deadline_s=30.0,
                                 on_failure=lambda: events.append("failed"),
                                 devices=["cpu"])
    got = sequence(mon, events)
    assert got == [(True, True, 1, 0, []),
                   (False, False, 2, 1, ["failed"]),
                   (False, False, 3, 2, ["failed"]),
                   (True, True, 4, 2, ["failed"])]
    jevents = []
    jmon = jserving.HealthMonitor(interval_s=0.05, deadline_s=30.0,
                                  on_failure=lambda: jevents.append("failed"))
    assert sequence(jmon, jevents) == got


def test_health_monitor_device_error_is_a_failure():
    events = []
    mon = tserving.HealthMonitor(on_failure=lambda: events.append(1),
                                 devices=["cpu"])
    mon._devices = [torch.device("meta")]   # .sum() cannot be read back
    assert mon.probe_once() is False
    assert not mon.healthy and mon.failures == 1 and events == [1]


def test_health_monitor_background_loop():
    mon = tserving.HealthMonitor(interval_s=0.01, devices=["cpu"]).start()
    deadline = time.monotonic() + 10.0
    while mon.probes < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert not mon._thread.is_alive()
    assert mon.probes >= 3 and mon.healthy and mon.failures == 0


def test_health_monitor_defaults_to_every_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tserving.HealthMonitor()


def tiny_graph(builder):
    """conv 3x3 s2 -> 1x1 gemm -> gap -> fc, 16x16x3 in, 10 classes: built
    from seed 21 by either package's GraphBuilder."""
    g = builder
    g.conv("stem", 3, 8, strides=(2, 2), padding=((0, 1), (0, 1)))
    g.conv("pw", 8, 16, kernel=(1, 1), padding=((0, 0), (0, 0)))
    g.gap("gap", 8)
    g.fc("fc", 16, 10)
    return g.finish()


@pytest.fixture(scope="module")
def tiny():
    jparams, jspec = tiny_graph(jgraph.GraphBuilder(np.random.default_rng(21)))
    tparams, tspec = tiny_graph(tgraph.GraphBuilder(
        np.random.default_rng(21), device="cpu"))
    return jparams, jspec, tparams, tspec


def test_infer_returns_the_direct_forward_row(tiny):
    jparams, jspec, tparams, tspec = tiny
    samples = np.random.default_rng(22).integers(
        0, 256, (5, 16, 16, 3), dtype=np.int64).astype(np.uint8)
    jax_rows = np.asarray(jax.jit(
        lambda p, v: jgraph.graph_forward(p, jspec, v))(
            jparams, jnp.asarray(samples)))
    direct = tgraph.graph_forward(tparams, tspec,
                                  torch.from_numpy(samples)).numpy()
    np.testing.assert_array_equal(direct, jax_rows)
    server = tserving.InferenceServer(
        lambda xb: tgraph.graph_forward(tparams, tspec, xb), (16, 16, 3),
        device="cpu", max_batch=4)
    with server:
        answers = [server.infer(x, timeout=60) for x in samples]
    for got, want in zip(answers, direct):
        np.testing.assert_array_equal(got, want)
    assert server.stats.requests == 5
    assert server.captured == []


def test_infer_from_many_threads(tiny):
    _, _, tparams, tspec = tiny
    samples = np.random.default_rng(23).integers(
        0, 256, (12, 16, 16, 3), dtype=np.int64).astype(np.uint8)
    direct = tgraph.graph_forward(tparams, tspec,
                                  torch.from_numpy(samples)).numpy()
    server = tserving.InferenceServer(
        lambda xb: tgraph.graph_forward(tparams, tspec, xb), (16, 16, 3),
        device="cpu", max_batch=8)
    answers = [None] * len(samples)

    def client(i):
        answers[i] = server.infer(samples[i], timeout=60)

    with server:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(samples))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(answers, direct):
        np.testing.assert_array_equal(got, want)
    assert server.stats.rows_useful == 12


def test_warmup_runs_every_bucket(tiny):
    _, _, tparams, tspec = tiny
    seen = []

    def forward(xb):
        seen.append(xb.shape[0])
        return tgraph.graph_forward(tparams, tspec, xb)

    server = tserving.InferenceServer(forward, (16, 16, 3), device="cpu",
                                      max_batch=6)
    assert server.warmup() is server
    assert seen == [1, 2, 4, 6]
    assert server.captured == []


def test_server_params_are_in_the_bucket_key(tiny):
    _, _, tparams, tspec = tiny
    params = list(tparams)
    samples = np.random.default_rng(24).integers(
        0, 256, (3, 16, 16, 3), dtype=np.int64).astype(np.uint8)
    direct = tgraph.graph_forward(params, tspec,
                                  torch.from_numpy(samples)).numpy()
    server = tserving.InferenceServer(
        lambda p, xb: tgraph.graph_forward(p, tspec, xb), (16, 16, 3),
        params=params, device="cpu", max_batch=4)
    with server:
        answers = [server.infer(x, timeout=60) for x in samples]
    for got, want in zip(answers, direct):
        np.testing.assert_array_equal(got, want)
    batch = torch.zeros((4, 16, 16, 3), dtype=torch.uint8)
    key = server._forward.key(*server._params, batch)
    # A record swapped in the caller's params: its bucket graphs miss.
    i = next(i for i, p in enumerate(params) if p is not None)
    params[i] = dataclasses.replace(params[i], w=params[i].w.clone())
    assert server._forward.key(*server._params, batch) != key
