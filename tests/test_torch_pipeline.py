"""The port's pipeline launcher, ``python -m
pytorch_cifar_tpu_torch.tools.pipeline_run``, as a child process on the
CPU (fp32 LeNet, a tiny synthetic split):

- pipeline mode (``--epochs 2``): the trainer child stages into
  ``<ckpt>/staging``, the first staged checkpoint bootstraps the live dir,
  the canary promotes at least once, the watcher reloads it, the client
  load sees no failure, and the run exits 0 with ONE JSON line;
- serve-only mode (``--epochs 0``), the drill the card runs at ResNet-18:
  a NaN'd candidate staged from outside is quarantined with the fleet's
  ``/predict`` bits unchanged, a good one is promoted and ``/predict``
  switches to its bits, and SIGTERM exits 0 with ``rejected == 1`` and
  ``promotions == 1``.
"""

import json
import os
import shutil
import signal
import time

import numpy as np

from pytorch_cifar_tpu_torch.serve import HttpTarget
from _torch_lifecycle import PORT, Child, images, save
from _torch_threads import torch_threads  # noqa: F401
from _torch_wire import get

LAUNCHER = "pytorch_cifar_tpu_torch.tools.pipeline_run"
READY = "==> pipeline: serving on "
CPU = ["--device", "cpu", "--model", "LeNet", "--poll_s", "0.1"]


def test_pipeline_mode_trains_vets_and_promotes(tmp_path):
    live = str(tmp_path / "pipe")
    run = Child([LAUNCHER, "--ckpt", live, "--epochs", "2", "--train-size",
                 "256", "--test-size", "128", "--batch", "64",
                 "--clients", "2", *CPU], READY)
    code, lines = run.finish(timeout=240)
    err = "".join(run.err)
    assert code == 0, err
    assert "==> pipeline: watching staging" in err and READY in err
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["harness"] == "pipeline_run" and rec["device"] == "cpu"
    assert rec["trainer_rc"] == 0 and rec["promotions"] >= 1
    assert rec["reloads"] >= 1 and rec["served_generation"] >= 1
    assert rec["load"]["failed"] == 0 and rec["load"]["requests"] > 0
    assert rec["canary_ms"]["golden_ms.count"] >= 2
    assert os.path.isfile(os.path.join(live, "staging", ".staging"))
    assert PORT.ckpt.read_meta(live, "ckpt.msgpack")["promotion"][
        "generation"] == rec["generation"]


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_serve_only_mode_quarantines_and_promotes_staged_candidates(
        tmp_path):
    live, b_dir = str(tmp_path / "live"), str(tmp_path / "b")
    save(live, 0, 1, 10.0)
    save(b_dir, 7, 4, 40.0)
    staging = PORT.ckpt.ensure_staging_dir(live)
    run = Child([LAUNCHER, "--ckpt", live, "--epochs", "0", "--golden",
                 "random", "--golden_n", "16", "--max_flip_frac", "1.0",
                 *CPU], READY)
    try:
        assert run.ready.wait(120), "".join(run.err)
        probe = images(3, 11)
        target = HttpTarget(run.url)
        pre = target.submit(probe).result()

        def health():
            return json.loads(get(run.url, "/healthz")[1])

        scratch = str(tmp_path / "scratch")
        shutil.copytree(b_dir, scratch)
        PORT.faults.regress_checkpoint(scratch, nan=True)
        PORT.ckpt.publish_checkpoint(scratch, staging)
        assert _wait(lambda: PORT.ckpt.read_quarantine(
            staging, "ckpt.msgpack") is not None)
        tomb = PORT.ckpt.read_quarantine(staging, "ckpt.msgpack")
        assert "nonfinite" in tomb["reason"]
        h = health()
        assert (h["ckpt_epoch"], h["promotion_generation"]) == (1, None)
        assert h["canary"]["state"] == "quarantined"
        assert np.array_equal(target.submit(probe).result(), pre)

        os.remove(PORT.ckpt.quarantine_path(staging, "ckpt.msgpack"))
        PORT.ckpt.publish_checkpoint(b_dir, staging)
        assert _wait(lambda: health()["ckpt_epoch"] == 4)
        h = health()
        assert h["promotion_generation"] == 1 and h["reloads"] == 1
        post = target.submit(probe).result()
        want = PORT.engine(b_dir, buckets=(1, 4, 8)).predict(probe)
        assert np.array_equal(post, want)
        target.close()
        run.proc.send_signal(signal.SIGTERM)
        code, lines = run.finish(timeout=120)
    finally:
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.wait(timeout=30)
    assert code == 0, "".join(run.err)
    rec = json.loads(lines[-1])
    assert (rec["rejected"], rec["promotions"], rec["generation"]) == (
        1, 1, 1)
    assert rec["served_epoch"] == 4 and rec["trainer_rc"] is None
