"""The trainer's observability and the host-loader CLI against the JAX
trainer's.

- ``--no-device_data --synthetic_data --epochs 2`` through the port's CLI
  on the CPU and the JAX ``Trainer`` on the same configuration: the same
  metric names in the ``--metrics_out`` JSONL (counters, gauges and
  histograms, letter for letter) and the same span names in the
  ``--trace_out`` Chrome JSON; every image counted once an epoch.
- ``prometheus_text`` of one snapshot equals the JAX function's; the
  exporter writes a final line; ``progress_bar`` and ``format_time`` print
  the JAX lines; ``set_logger`` is rank-aware.
- ``--profile`` writes a ``torch.profiler`` trace under ``output_dir`` on
  both data planes.
"""

import io
import json
import logging
import os

import pytest

from pytorch_cifar_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_cifar_tpu.obs import prometheus_text as jax_prometheus_text
from pytorch_cifar_tpu.obs import trace as jax_trace
from pytorch_cifar_tpu.train.trainer import Trainer as JaxTrainer
from pytorch_cifar_tpu.utils import progress as jax_progress
from pytorch_cifar_tpu_torch.obs import (
    MetricsExporter,
    MetricsRegistry,
    prometheus_text,
    write_prometheus,
)
from pytorch_cifar_tpu_torch.train.__main__ import main as train_main
from pytorch_cifar_tpu_torch.utils import format_time, progress, set_logger
from _torch_threads import torch_threads  # noqa: F401

RUN = dict(model="LeNet", synthetic_data=True, synthetic_train_size=160,
           synthetic_test_size=64, batch_size=32, eval_batch_size=32,
           epochs=2, amp=False, device_data=False, host_augment=True,
           lr=0.05, log_every=2)


def _argv(cfg: dict) -> list:
    out = []
    for k, v in cfg.items():
        if isinstance(v, bool):
            out.append(f"--{k}" if v else f"--no-{k}")
        else:
            out += [f"--{k}", str(v)]
    return out


def _names(jsonl: str) -> dict:
    with open(jsonl) as f:
        last = json.loads(f.read().splitlines()[-1])["metrics"]
    return {kind: sorted(v) for kind, v in last.items()}


def _spans(path: str) -> set:
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for tag in ("port", "jax"):
        cfg = dict(RUN, output_dir=str(d / tag),
                   metrics_out=str(d / tag / "m.jsonl"),
                   trace_out=str(d / tag / "t.json"))
        if tag == "port":
            out[tag] = train_main(_argv(cfg) + ["--device", "cpu"])
        else:
            try:
                JaxTrainer(JaxTrainConfig(num_devices=1, **cfg)).fit()
            finally:
                jax_trace.uninstall()
        out[tag + "_dir"] = str(d / tag)
    return out


def test_host_loader_cli_reports_the_jax_trainers_metric_names(runs):
    got = _names(os.path.join(runs["port_dir"], "m.jsonl"))
    want = _names(os.path.join(runs["jax_dir"], "m.jsonl"))
    assert got == want
    for name in ("train.input_wait_ms", "train.step_time_ms",
                 "data.host_batch_ms", "data.producer_batch_ms"):
        assert name in got["histograms"]
    assert "data.prefetch_depth" in got["gauges"]
    hist = runs["port"]["history"]
    assert [h["train"]["count"] for h in hist] == [160, 160]
    assert all(h["eval"]["count"] == 64 for h in hist)


def test_trace_out_holds_the_jax_trainers_spans(runs):
    got = _spans(os.path.join(runs["port_dir"], "t.json"))
    want = _spans(os.path.join(runs["jax_dir"], "t.json"))
    assert got == want
    assert {"train/epoch", "train/step", "eval/epoch"} <= got


def test_prometheus_text_is_the_jax_text(tmp_path):
    reg = MetricsRegistry()
    reg.counter("train.epochs").inc(3)
    reg.gauge("data.prefetch_depth").set(2)
    h = reg.histogram("train.step_time_ms")
    for v in (0.3, 7.0, 7.5, 120.0, 7e4):
        h.observe(v)
    snap = reg.snapshot()
    assert prometheus_text(snap) == jax_prometheus_text(snap)
    write_prometheus(str(tmp_path / "m.prom"), snap, prefix="x")
    assert (tmp_path / "m.prom").read_text() == prometheus_text(snap, "x")
    path = tmp_path / "e.jsonl"
    MetricsExporter(reg, str(path), interval_s=60).start().stop()
    (line,) = path.read_text().splitlines()
    assert json.loads(line)["metrics"] == snap


def test_progress_bar_and_format_time_print_the_jax_lines(monkeypatch):
    for s in (0.0, 0.0123, 4.5, 61.2, 3700.0, 200000.0):
        assert format_time(s) == jax_progress.format_time(s)
    lines = []
    for mod in (progress, jax_progress):
        clock = iter(range(1, 100))
        monkeypatch.setattr(mod.time, "time", lambda: next(clock) * 0.5)
        mod._last_time = mod._begin_time = None
        buf = io.StringIO()
        for i in range(7):
            mod.progress_bar(i, 7, f"Loss: {i}", stream=buf, log_every=3)
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and lines[0].count("\n") == 3


def test_set_logger_is_rank_aware(tmp_path):
    root = logging.getLogger()
    before = list(root.handlers)
    path = str(tmp_path / "train.rank1.log")
    try:
        set_logger(path, process_index=1)
        stream = next(h for h in root.handlers
                      if type(h) is logging.StreamHandler)
        assert stream.level == logging.WARNING
        logging.getLogger("x").info("only in the file")
        set_logger(None, process_index=0)
        assert stream.level == logging.INFO
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
                h.close()
    assert "only in the file" in open(path).read()


@pytest.mark.parametrize("device_data", [True, False])
def test_profile_writes_a_trace_under_output_dir(tmp_path, device_data):
    cfg = dict(RUN, epochs=2, output_dir=str(tmp_path), profile=True,
               host_augment=False, device_data=device_data)
    train_main(_argv(cfg) + ["--device", "cpu"])
    (name,) = os.listdir(tmp_path / "profile")
    assert name == "epoch1.trace.json"
    with open(tmp_path / "profile" / name) as f:
        assert json.load(f)["traceEvents"]
