"""Zoo-wide train throughput sweep on the card: one line per model, img/s:

    python -m pytorch_cifar_tpu_torch.tools.zoo_bench          # one per family
    python -m pytorch_cifar_tpu_torch.tools.zoo_bench --all \\
        --out pytorch_cifar_tpu_torch/tools/zoo_sweep_h100.json
    python -m pytorch_cifar_tpu_torch.tools.zoo_bench --models ResNet18 DPN92

The port's counterpart of ``tools/zoo_bench.py``, with its protocol and
flags: for each model, ``--warmup`` train steps, then ``--repeats`` blocks
of ``--steps`` steps at ``--batch`` (bf16 compute, crop and flip on, SGD;
the trainer's default step), four batches staged on the card before the
timed window, each block ended by fetching its last step's loss (the
steps chain through the state, so the fetch waits for the whole block);
the best block's img/s is the model's number. By default each model runs
in a fresh child process (``--no-isolate``: one shared process), so a
model's number does not carry another's allocator state.

``--out`` gets ``{"platform": "gpu", "card": ..., "protocol": {...},
"results": {model: {"images_per_sec", "batch"}}}``, rewritten after each
model; ``card`` is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them. The
serving zoo's cost priors (``serve.tenancy.COST_PRIORS_PATH``) are this
file, run with ``--all``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# one representative per reference module, as the JAX sweep's default
FAMILY_REPS = [
    "LeNet", "VGG19", "ResNet18", "PreActResNet18", "SENet18",
    "GoogLeNet", "DenseNet121", "ResNeXt29_32x4d", "MobileNet",
    "MobileNetV2", "EfficientNetB0", "RegNetX_200MF", "DPN92",
    "ShuffleNetG2", "ShuffleNetV2_1", "PNASNetA", "SimpleDLA", "DLA",
]


def run_one(name: str, batch: int, steps: int, warmup: int,
            repeats: int) -> float:
    """Best-of-``repeats`` train img/s of ``name`` on the card."""
    import torch

    from pytorch_cifar_tpu_torch.models import create_model
    from pytorch_cifar_tpu_torch.train.optim import (
        cosine_epoch_schedule,
        make_optimizer,
    )
    from pytorch_cifar_tpu_torch.train.state import create_train_state
    from pytorch_cifar_tpu_torch.train.steps import make_train_step

    g = torch.Generator().manual_seed(0)
    batches = [
        (torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                       dtype=torch.uint8).cuda(),
         torch.randint(0, 10, (batch,), generator=g,
                       dtype=torch.int32).cuda())
        for _ in range(4)
    ]
    model = create_model(name, generator=g).to(
        "cuda", memory_format=torch.channels_last)
    state = create_train_state(
        model, make_optimizer(model.parameters()),
        cosine_epoch_schedule(0.1, 200, 98), device="cuda",
    )
    step = make_train_step(compute_dtype=torch.bfloat16, device="cuda")
    metrics = None
    for i in range(warmup):
        metrics = step(state, batches[i % len(batches)])
    if metrics is not None:
        float(metrics["loss_sum"])
    best = 0.0
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = step(state, batches[i % len(batches)])
        loss = float(metrics["loss_sum"]) / float(metrics["count"])
        elapsed = time.perf_counter() - t0
        if loss != loss or abs(loss) == float("inf"):
            raise RuntimeError(f"non-finite loss {loss} for {name}")
        best = max(best, steps * batch / elapsed)
    return best


def _bench_inline(names, args, results, flush_out) -> None:
    for name in names:
        t0 = time.perf_counter()
        try:
            rate = run_one(name, args.batch, args.steps, args.warmup,
                           args.repeats)
        except Exception as e:  # keep sweeping past a single bad model
            print(f"{name:20s} FAILED: {type(e).__name__}: {e}", flush=True)
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            flush_out()
            continue
        results[name] = {"images_per_sec": round(rate, 1),
                         "batch": args.batch}
        ms = args.batch * 1000 / rate
        print(f"{name:20s} {rate:10.0f} img/s  ({ms:6.2f} ms/step, sweep "
              f"{time.perf_counter() - t0:.0f}s)", flush=True)
        flush_out()


def _bench_isolated(names, args, results, flush_out) -> None:
    """One child process per model, its result handed back through a
    temporary ``--out`` file."""
    base = [
        sys.executable, "-m", "pytorch_cifar_tpu_torch.tools.zoo_bench",
        "--no-isolate", "--batch", str(args.batch), "--steps",
        str(args.steps), "--warmup", str(args.warmup), "--repeats",
        str(args.repeats),
    ]
    for name in names:
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            proc = subprocess.run(base + ["--models", name, "--out", tmp],
                                  capture_output=True, text=True,
                                  timeout=3600)
            try:
                child = json.loads(Path(tmp).read_text())
            except (OSError, ValueError):
                child = {}
            if name in child.get("results", {}):
                results[name] = child["results"][name]
            else:
                tail = (proc.stderr or proc.stdout or "")[-300:]
                results[name] = {
                    "error": f"subprocess rc={proc.returncode}: {tail}"}
        except subprocess.TimeoutExpired:
            results[name] = {"error": "subprocess timeout (3600s)"}
        finally:
            os.remove(tmp)
        r = results[name]
        if "error" in r:
            print(f"{name:20s} FAILED: {r['error']}", flush=True)
        else:
            rate = r["images_per_sec"]
            ms = args.batch * 1000 / rate
            print(f"{name:20s} {rate:10.0f} img/s  ({ms:6.2f} ms/step, "
                  f"isolated {time.perf_counter() - t0:.0f}s)", flush=True)
        flush_out()


def main(argv=None) -> int:
    from pytorch_cifar_tpu_torch.models import available_models
    from pytorch_cifar_tpu_torch.tools._bench import card_line

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--models", nargs="*", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--out", default=None, help="write JSON results here")
    parser.add_argument(
        "--isolate", action=argparse.BooleanOptionalAction, default=True,
        help="fresh process per model (default)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("zoo_bench: CUDA is not available; the sweep "
                         "measures the card")
    if args.models:
        names = args.models
    elif args.all:
        names = list(available_models())
    else:
        names = FAMILY_REPS
    unknown = sorted(set(names) - set(available_models()))
    if unknown:
        raise SystemExit(f"zoo_bench: unknown models {unknown}")
    isolated = args.isolate and len(names) > 1
    card = card_line()
    print(card, flush=True)
    results: dict = {}
    protocol = {
        "steps": args.steps,
        "warmup": args.warmup,
        "repeats": args.repeats,
        "isolated": isolated,
        "note": (
            "best-of-N step blocks, train step at bf16 compute with crop "
            "and flip, four batches staged on the card, a loss fetch ends "
            "each block" + ("; one fresh process per model" if isolated
                            else "; shared process")
        ),
    }

    def flush_out():
        # incremental: a failure at model 25 keeps the first 24
        if args.out:
            Path(args.out).write_text(json.dumps({
                "platform": "gpu",
                "card": card,
                "device": torch.cuda.get_device_name(0),
                "protocol": protocol,
                "results": results,
            }, indent=1) + "\n")

    if isolated:
        _bench_isolated(names, args, results, flush_out)
    else:
        _bench_inline(names, args, results, flush_out)
    ok = {k: v for k, v in results.items() if "error" not in v}
    if ok:
        ranked = sorted(ok, key=lambda k: ok[k]["images_per_sec"])
        print("\nslowest five:", ", ".join(ranked[:5]))
    return 0 if len(ok) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
