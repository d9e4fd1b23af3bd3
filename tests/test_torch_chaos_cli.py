"""The port's drill's own process and the train CLI's signal handling.

- The drill's own process loads no torch: ``--help`` and every module its modes
  import run in a fresh interpreter with ``torch`` absent from
  ``sys.modules`` (the children own the device), the rollout mode's edge
  (router, frontend, journal follower) and the zoo mode's cost priors
  among them. ``train/checkpoint.py`` imports the tree mapping and the
  process group where they are used, so its staging and publish helpers
  load no torch either.
- The drill's modes are the JAX drill's thirteen, ``--serve-devices``
  takes any group of one device or more, and without a card the default
  ``--device cuda`` fails through its first child.
- The record keys pinned in ``tests/_torch_chaos.py`` are the JAX drill's,
  read from JAX's ``tools/chaos_run.py`` by ``ast``.
- The train CLI handles SIGTERM for its whole life: one that lands after
  the run (the interpreter's teardown) exits 0 instead of killing it, one
  that lands before the epochs stops after the first.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from pytorch_cifar_tpu_torch.config import TrainConfig
from pytorch_cifar_tpu_torch.tools import chaos_run
from pytorch_cifar_tpu_torch.train import checkpoint as port_ckpt
from pytorch_cifar_tpu_torch.train import launch
from _torch_chaos import COMPARE_KEYS, RECORD_KEYS, REPO, TRAINER_KEYS
from _torch_threads import THREADS, torch_threads  # noqa: F401

JAX_MODES = ("sigterm", "sigkill", "corrupt", "nan", "serve", "ckpt",
             "router", "canary", "zoo", "mesh", "elastic", "edge",
             "rollout")  # JAX tools/chaos_run.py:2663-2667


def _fresh(code: str) -> dict:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_the_drill_process_loads_no_torch():
    got = _fresh(
        "import json, runpy, sys\n"
        "sys.argv = ['chaos_run', '--help']\n"
        "try:\n"
        "    runpy.run_module('pytorch_cifar_tpu_torch.tools.chaos_run',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "import pytorch_cifar_tpu_torch.faults\n"
        "import pytorch_cifar_tpu_torch.serialization\n"
        "import pytorch_cifar_tpu_torch.obs\n"
        "import pytorch_cifar_tpu_torch.serve.fleet\n"
        "import pytorch_cifar_tpu_torch.serve.frontend\n"
        "import pytorch_cifar_tpu_torch.serve.journal\n"
        "import pytorch_cifar_tpu_torch.serve.loadgen\n"
        "import pytorch_cifar_tpu_torch.serve.priors\n"
        "import pytorch_cifar_tpu_torch.serve.router\n"
        "import pytorch_cifar_tpu_torch.tools.journal_inspect\n"
        "import pytorch_cifar_tpu_torch.train.checkpoint\n"
        "print(json.dumps({'code': code, 'torch': 'torch' in sys.modules}))")
    assert got == {"code": 0, "torch": False}


def test_checkpoint_publish_helpers_load_no_torch():
    got = _fresh(
        "import json, sys\n"
        "from pytorch_cifar_tpu_torch.train.checkpoint import (\n"
        "    ensure_staging_dir, publish_checkpoint, quarantine_path,\n"
        "    read_quarantine)\n"
        "print(json.dumps({'torch': 'torch' in sys.modules}))")
    assert got == {"torch": False}


def test_modes_are_the_jax_thirteen(capsys):
    assert chaos_run.MODES == JAX_MODES
    for mode in JAX_MODES:
        assert chaos_run.parse_args(["--mode", mode]).mode == mode
    with pytest.raises(SystemExit) as e:
        chaos_run.parse_args(["--mode", "fleet"])
    assert e.value.code == 2
    capsys.readouterr()
    args = chaos_run.parse_args([])
    assert (args.device, args.model, args.epochs, args.train_size,
            args.test_size, args.batch, args.lr, args.kill_delay_s,
            args.nan_step, args.serve_devices) == (
        "cuda", "LeNet", 3, 512, 256, 64, 0.02, 0.5, 2, 1)


def test_serve_devices_other_than_one_is_not_ported(capsys):
    """Serving over a device group is ported: ``--serve-devices 8`` (JAX's
    default) is taken, and only a group of no device is refused."""
    args = chaos_run.parse_args(["--mode", "serve", "--serve-devices", "8"])
    assert args.serve_devices == 8
    with pytest.raises(SystemExit) as e:
        chaos_run.parse_args(["--mode", "serve", "--serve-devices", "0"])
    assert e.value.code == 2
    assert "need 1 or more" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the drill's failure where there is no "
                           "card")
def test_default_device_without_a_card_fails(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_cifar_tpu_torch.tools.chaos_run",
         "--mode", "sigkill", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


def _jax_functions() -> dict:
    with open(os.path.join(REPO, "tools", "chaos_run.py")) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _dict_keys(node: ast.Dict) -> set:
    keys = set()
    for k, v in zip(node.keys, node.values):
        if k is not None:
            keys.add(k.value)
        else:  # ``**{k: ... for k, v in cmp.items()}``
            assert isinstance(v, ast.DictComp), ast.dump(v)
            keys |= COMPARE_KEYS
    return keys


def test_pinned_record_keys_are_the_jax_drill_s():
    funcs = _jax_functions()
    (ret,) = [n for n in ast.walk(funcs["compare"])
              if isinstance(n, ast.Return)]
    assert _dict_keys(ret.value) == COMPARE_KEYS
    for mode in ("serve", "ckpt", "router", "canary", "zoo", "mesh",
                 "elastic", "edge", "rollout"):
        rets = [n.value for n in ast.walk(funcs[f"{mode}_drill"])
                if isinstance(n, ast.Return) and isinstance(n.value,
                                                            ast.Dict)]
        assert [_dict_keys(r) for r in rets] == [RECORD_KEYS[mode]], mode
    main = funcs["main"]
    (record,) = [n.value for n in ast.walk(main)
                 if isinstance(n, ast.Assign) and isinstance(n.value,
                                                             ast.Dict)
                 and getattr(n.targets[0], "id", "") == "record"]
    assert _dict_keys(record) == TRAINER_KEYS == RECORD_KEYS["nan"]
    (interrupted,) = [n.value for n in ast.walk(main)
                      if isinstance(n, ast.Assign)
                      and getattr(n.targets[0], "id", "") == "interrupted"
                      and isinstance(n.value, ast.Dict)]
    assert _dict_keys(interrupted) == {"signal", "rc"}
    extra = {n.targets[0].slice.value for n in ast.walk(main)
             if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Subscript)}
    assert extra == {"corruption"}
    for mode in ("sigterm", "sigkill"):
        assert RECORD_KEYS[mode] == TRAINER_KEYS | {"signal", "rc"}
    assert RECORD_KEYS["corrupt"] == TRAINER_KEYS | {"signal", "rc",
                                                     "corruption"}


def _cli(out_dir):
    return subprocess.Popen(
        [sys.executable, "-u", "-m", "pytorch_cifar_tpu_torch.train",
         "--model", "LeNet", "--synthetic_data", "--synthetic_train_size",
         "64", "--synthetic_test_size", "32", "--batch_size", "32",
         "--epochs", "1", "--no-amp", "--output_dir", str(out_dir),
         "--device", "cpu", "--num_devices", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": str(THREADS)})


def test_train_cli_sigterm_after_the_run_exits_0(tmp_path):
    """The run is complete and on disk once the CLI prints its result; a
    SIGTERM then lands in the interpreter's teardown (most of a second
    after a torch run), which used to kill the process (rc -15), so a
    drill whose signal came late counted a finished run as a failed
    one."""
    for i, delay_s in enumerate((0.0, 0.3)):
        proc = _cli(tmp_path / str(i))
        for line in proc.stdout:
            if line.startswith("best test accuracy"):
                time.sleep(delay_s)
                proc.send_signal(signal.SIGTERM)
                break
        proc.stdout.close()
        assert proc.wait(timeout=120) == 0
        assert os.path.isfile(tmp_path / str(i) / "ckpt.msgpack")
        assert not os.path.exists(tmp_path / str(i) / "last.msgpack")


def test_stop_requested_before_the_epochs_stops_after_the_first(tmp_path):
    config = TrainConfig(model="LeNet", synthetic_data=True,
                         synthetic_train_size=64, synthetic_test_size=32,
                         batch_size=32, epochs=3, amp=False, device="cpu",
                         output_dir=str(tmp_path))
    stop = threading.Event()
    stop.set()
    out = launch.run(config, stop=stop)
    assert [h["epoch"] for h in out["history"]] == [0]
    assert port_ckpt.read_meta(str(tmp_path), "last.msgpack")["epoch"] == 0
