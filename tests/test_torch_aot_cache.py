"""The port's cold-start cache (``serve/aot_cache.py`` and the engine's
``aot_cache_dir``) against the JAX package's.

The JAX engine's cache imports fail on XLA:CPU (its deserialized programs
expect the 8 virtual devices' shards), so it is no oracle here. The port is
held against what holds: JAX's pure functions (``fingerprint``,
``entry_name``) on the same key fields, JAX's ``tools/ckpt_inspect.py``
reading a port cache directory, the assertions of JAX's three engine cache
tests (``tests/test_serve.py``), mirrored for LeNet and ResNet18 in fp32 at
its buckets, and the JAX engine built with ``aot_cache_dir=None`` on the
same checkpoint. A hit must skip the preparation: an engine on a populated
cache builds with the checkpoint's decode and the preparation disabled.
"""

import hashlib
import importlib.util
import io
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_cifar_tpu.serve import InferenceEngine as JaxEngine
from pytorch_cifar_tpu.serve import aot_cache as jax_cache
from pytorch_cifar_tpu.train import checkpoint as jax_ckpt
from pytorch_cifar_tpu_torch import faults
from pytorch_cifar_tpu_torch.obs import MetricsRegistry
from pytorch_cifar_tpu_torch.serve import (
    InferenceEngine,
    ModelZooServer,
    TenantSpec,
    aot_cache,
)
from pytorch_cifar_tpu_torch.serve import engine as engine_mod
from pytorch_cifar_tpu_torch.serve.engine import state_digest
from pytorch_cifar_tpu_torch.train.checkpoint import (
    CheckpointCorrupt,
    _atomic_write,
    payload_manifest,
    publish_fingerprint,
)
from _torch_ckpt import jax_state
from _torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("LeNet", "ResNet18")
KW = {"compute_dtype": torch.float32, "device": "cpu"}


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_checkpoint(out_dir, model, seed):
    """A JAX-written v2 checkpoint of ``model``, every leaf from ``seed``."""
    jax_ckpt.save_checkpoint(str(out_dir), jax_state(model, seed), 3, 50.0)
    return str(out_dir)


def _entries(cache):
    return sorted(n for n in os.listdir(cache) if ".aotx" in n)


def test_fingerprint_and_entry_name_are_the_jax_functions(tmp_path):
    eng = InferenceEngine.from_random("LeNet", buckets=(1, 4), **KW)
    keys = [eng._cache_key_fields(b) for b in (1, 4, None)]
    keys.append({"model": "ResNet18", "bucket": 128, "mean": [0.5] * 3,
                 "weights": {"publish": {"crc32": 7, "size": 9}}})
    for key in keys:
        digest = aot_cache.fingerprint(key)
        assert digest == jax_cache.fingerprint(key)
        b = key.get("bucket", 0)
        assert aot_cache.entry_name(key["model"], b, digest) == \
            jax_cache.entry_name(key["model"], b, digest)
    # the key names the card's kind of device, never another's
    assert keys[0]["platform"] == "cpu" and keys[0]["device"] == "cpu"
    assert keys[0]["weights"] == {"random_seed": 0}


def test_inspect_aot_cache_of_both_packages_reads_a_port_cache(tmp_path):
    cache = str(tmp_path / "aot")
    for name in MODELS:
        InferenceEngine.from_random(name, buckets=(1, 4),
                                    aot_cache_dir=cache, **KW)
    port = _jax_tool("ckpt_inspect")  # the JAX package's tool
    from pytorch_cifar_tpu_torch.tools import ckpt_inspect

    (victim,) = [n for n in _entries(cache)
                 if n.startswith("LeNet_b4_") and n.endswith(".aotx")]
    for poisoned in ([], [victim]):
        if poisoned:
            aot_cache.poison_entry(cache, victim, "test")
        got, want = ckpt_inspect.inspect_aot_cache(cache), \
            port.inspect_aot_cache(cache)
        assert got == want
        assert [(e["model"], e["bucket"]) for e in want["entries"]] == [
            ("LeNet", 1), ("LeNet", 4), ("ResNet18", 1), ("ResNet18", 4)]
        assert want["poisoned"] == poisoned
        # the whole report, exit code included: a cache dir is no
        # checkpoint dir, and the weight sets in weights/ are not listed
        assert ckpt_inspect.main([cache, "--json"]) == \
            port.main([cache, "--json"]) == 0


@pytest.mark.parametrize("name", MODELS)
def test_aot_cache_cold_start_zero_compiles(tmp_path, name):
    """JAX's acceptance pin: the second engine on a populated cache warms
    every bucket on a verified entry, with logits bit for bit the first's."""
    cache = str(tmp_path / "aot")
    reg = MetricsRegistry()
    e1 = InferenceEngine.from_random(name, buckets=(1, 4),
                                     aot_cache_dir=cache, registry=reg, **KW)
    assert e1.compile_count == 2
    assert e1.aot_cache_misses == 2 and e1.aot_cache_hits == 0
    # two bucket entries + their sidecars, atomically published, and the
    # weight set they share
    assert _entries(cache) == sorted(
        n for b in (1, 4) for n in os.listdir(cache)
        if n.startswith(f"{name}_b{b}_"))
    assert len(_entries(cache)) == 4
    assert len(os.listdir(tmp_path / "aot" / "weights")) == 2

    reg2 = MetricsRegistry()
    e2 = InferenceEngine.from_random(name, buckets=(1, 4),
                                     aot_cache_dir=cache, registry=reg2,
                                     **KW)
    assert e2.compile_count == 0
    assert e2.aot_cache_hits == 2 and e2.aot_cache_misses == 0
    for n in (1, 3, 4, 9):  # padding + chunking through imported weights
        x = _images(n, seed=n)
        np.testing.assert_array_equal(e2.predict(x), e1.predict(x))
    s2 = reg2.summary()
    assert s2["serve.aot_cache_hits"] == 2.0
    assert s2.get("serve.compiles", 0.0) == 0.0
    assert reg2.gauge("serve.cold_start_s").value > 0.0


def _negate_probe(cache, entry_file):
    path = os.path.join(cache, entry_file)
    with open(path, "rb") as f:
        entry = torch.load(io.BytesIO(f.read()), weights_only=False)
    entry["probe_logits"] = -np.asarray(entry["probe_logits"])
    buf = io.BytesIO()
    torch.save(entry, buf)
    payload = buf.getvalue()
    _atomic_write(path, payload)
    with open(path + ".json") as f:
        meta = json.load(f)
    meta["manifest"] = payload_manifest(payload)
    _atomic_write(path + ".json", json.dumps(meta).encode())


@pytest.mark.parametrize("name", MODELS)
def test_aot_cache_probe_mismatch_poisons_and_recompiles(tmp_path, name):
    """An entry whose probe cannot be reproduced is refused: the engine
    prepares instead, the entry is poisoned, and later engines treat it as
    a permanent miss that no export writes over."""
    cache = str(tmp_path / "aot")
    e1 = InferenceEngine.from_random(name, buckets=(4,), aot_cache_dir=cache,
                                     **KW)
    (entry_file,) = [n for n in os.listdir(cache) if n.endswith(".aotx")]
    _negate_probe(cache, entry_file)
    meta_p = os.path.join(cache, entry_file + ".json")
    e2 = InferenceEngine.from_random(name, buckets=(4,), aot_cache_dir=cache,
                                     **KW)
    assert e2.compile_count == 1
    assert e2.aot_cache_hits == 0 and e2.aot_cache_misses == 1
    with open(meta_p) as f:
        assert json.load(f)["poisoned"] is True
    e3 = InferenceEngine.from_random(name, buckets=(4,), aot_cache_dir=cache,
                                     **KW)
    assert e3.compile_count == 1 and e3.aot_cache_misses == 1
    with open(meta_p) as f:
        assert json.load(f)["poisoned"] is True
    x = _images(3)
    np.testing.assert_array_equal(e3.predict(x), e1.predict(x))


@pytest.mark.parametrize("part", ["bucket", "weights"])
@pytest.mark.parametrize("name", MODELS)
def test_torn_aot_cache_entry_is_a_miss(tmp_path, name, part):
    """A truncated entry fails its manifest and reads as a miss: a torn
    bucket entry misses its bucket, a torn weight set every bucket."""
    cache = str(tmp_path / "aot")
    e1 = InferenceEngine.from_random(name, buckets=(4,), aot_cache_dir=cache,
                                     **KW)
    folder = cache if part == "bucket" else os.path.join(cache, "weights")
    (entry_file,) = [n for n in os.listdir(folder) if n.endswith(".aotx")]
    faults.truncate_file(os.path.join(folder, entry_file))
    e2 = InferenceEngine.from_random(name, buckets=(4,), aot_cache_dir=cache,
                                     **KW)
    assert e2.compile_count == 1 and e2.aot_cache_misses == 1
    assert e2.aot_cache_hits == 0
    x = _images(2)
    np.testing.assert_array_equal(e2.predict(x), e1.predict(x))


@pytest.mark.parametrize("field,value", [
    ("mean", (0.5, 0.5, 0.5)), ("num_classes", 100), ("int8", True),
    ("seed", 1)])
def test_a_different_key_field_is_a_miss(tmp_path, field, value):
    cache = str(tmp_path / "aot")
    InferenceEngine.from_random("LeNet", buckets=(1, 4), aot_cache_dir=cache,
                                **KW)
    eng = InferenceEngine.from_random("LeNet", buckets=(1, 4),
                                      aot_cache_dir=cache,
                                      **{field: value}, **KW)
    assert (eng.compile_count, eng.aot_cache_hits,
            eng.aot_cache_misses) == (2, 0, 2)


def test_a_hit_skips_the_preparation(tmp_path, monkeypatch):
    """The definition of a hit: a bucket warmed on a verified entry, with
    the checkpoint's decode, model load and fold skipped. The second engine
    builds with the decode and the preparation disabled; its stages show
    the checkpoint's read and digest, the cache's read and transfer and the
    model's skeleton; ``compile_count`` stays 0. ``weights_host`` decodes
    the payload read at start: a file damaged since does not reach it."""
    ckpt = _jax_checkpoint(tmp_path / "ckpt", "ResNet18", 3)
    cache = str(tmp_path / "aot")
    e1 = InferenceEngine.from_checkpoint(ckpt, "ResNet18", buckets=(1, 4),
                                         aot_cache_dir=cache, **KW)
    assert {"checkpoint_read_ms", "decode_ms", "model_ms",
            "fold_ms"} <= set(e1.cold_start_stages)

    def refuse(*a, **kw):
        raise AssertionError("a hit prepared the weights")

    monkeypatch.setattr(InferenceEngine, "_prepare_weights", refuse)
    monkeypatch.setattr(engine_mod, "_decode_msgpack_state", refuse)
    e2 = InferenceEngine.from_checkpoint(ckpt, "ResNet18", buckets=(1, 4),
                                         aot_cache_dir=cache, **KW)
    assert (e2.compile_count, e2.aot_cache_hits) == (0, 2)
    assert set(e2.cold_start_stages) == {
        "checkpoint_read_ms", "checkpoint_digest_ms", "cache_read_ms",
        "cache_put_ms", "model_ms", "b1_first_ms", "b4_first_ms"}
    assert e2.checkpoint_meta == e1.checkpoint_meta
    assert e2.ready_s >= e2.cold_start_s > 0.0
    x = _images(5, seed=1)
    np.testing.assert_array_equal(e2.predict(x), e1.predict(x))
    # the model is a skeleton: the card holds the folded tree alone
    assert all(p.is_meta for p in e2._weights[0].parameters())
    monkeypatch.undo()
    faults.bitflip_file(os.path.join(ckpt, "ckpt.msgpack"))
    host, want = e2.weights_host(), e1.weights_host()
    assert list(host) == list(want)
    for k in want:
        np.testing.assert_array_equal(host[k], want[k])
    assert e2.swap_weights(host) == 1
    np.testing.assert_array_equal(e2.predict(x), e1.predict(x))
    # a damaged payload is no hit: it fails as it does without a cache
    with pytest.raises(CheckpointCorrupt, match="crc32"):
        InferenceEngine.from_checkpoint(ckpt, "ResNet18", buckets=(1, 4),
                                        aot_cache_dir=cache, **KW)


def test_a_checkpoint_is_named_by_its_bytes(tmp_path):
    """With a cache, a checkpoint's weight set is named by its publish
    fingerprint and the SHA-256 of its payload (the fingerprint's CRC
    alone is 32 bits): the key holds both, and another generation of the
    same size misses."""
    ckpt = _jax_checkpoint(tmp_path / "ckpt", "LeNet", 3)
    cache = str(tmp_path / "aot")
    kw = dict(buckets=(1,), aot_cache_dir=cache, **KW)
    e1 = InferenceEngine.from_checkpoint(ckpt, "LeNet", **kw)
    with open(os.path.join(ckpt, "ckpt.msgpack"), "rb") as f:
        payload = f.read()
    assert e1._cache_key_fields(None)["weights"] == {
        "publish": publish_fingerprint(e1.checkpoint_meta),
        "sha256": hashlib.sha256(payload).hexdigest()}
    _jax_checkpoint(tmp_path / "ckpt", "LeNet", 4)
    e2 = InferenceEngine.from_checkpoint(ckpt, "LeNet", **kw)
    assert e2.checkpoint_meta["manifest"]["size"] == len(payload)
    assert (e2.compile_count, e2.aot_cache_misses) == (1, 1)


def test_an_engine_from_the_cache_enables_a_canary_after_a_republish(
        tmp_path):
    """The canary controller snapshots ``weights_host()`` of an engine
    built from the tenant's live directory. Built from the cache, that
    engine keeps the weights it serves after the live directory is
    republished: the controller starts, and its incumbent is the served
    generation."""
    from pytorch_cifar_tpu_torch.serve.canary import (
        GoldenSet,
        PromotionController,
    )

    live = _jax_checkpoint(tmp_path / "live", "LeNet", 3)
    cache = str(tmp_path / "aot")
    kw = dict(buckets=(1, 4), aot_cache_dir=cache, **KW)
    e1 = InferenceEngine.from_checkpoint(live, "LeNet", **kw)
    canary = InferenceEngine.from_checkpoint(live, "LeNet", **kw)
    assert canary.aot_cache_hits == 2
    _jax_checkpoint(tmp_path / "live", "LeNet", 4)  # a promotion
    ctl = PromotionController(canary, str(tmp_path / "staging"), live,
                              golden=GoldenSet.random(8, seed=3))
    want = e1.weights_host()
    for k, v in ctl._incumbent.items():
        np.testing.assert_array_equal(v, want[k])


def test_the_port_on_a_hit_agrees_with_the_jax_engine(tmp_path):
    """The same JAX-written checkpoint: the port's engine imported from its
    cache within rtol 1e-4 of the JAX engine with no cache."""
    ckpt = _jax_checkpoint(tmp_path / "ckpt", "LeNet", 5)
    cache = str(tmp_path / "aot")
    for _ in range(2):
        port = InferenceEngine.from_checkpoint(ckpt, "LeNet", buckets=(1, 4),
                                               aot_cache_dir=cache, **KW)
    assert port.aot_cache_hits == 2
    jeng = JaxEngine.from_checkpoint(ckpt, "LeNet", buckets=(1, 4),
                                     compute_dtype=jnp.float32,
                                     aot_cache_dir=None)
    x = _images(6, seed=2)
    np.testing.assert_allclose(port.predict(x), jeng.predict(x), rtol=1e-4,
                               atol=1e-5)


def test_concurrent_exports_leave_one_whole_entry(tmp_path):
    """Replicas that miss together export the same names: the exports take
    turns, and every entry reads back whole."""
    cache = str(tmp_path / "aot")
    key = {"model": "LeNet", "bucket": 4}
    name = aot_cache.entry_name("LeNet", 4, aot_cache.fingerprint(key))
    body = {"probe_logits": np.arange(4000, dtype=np.float32)}
    threads = [threading.Thread(target=aot_cache.export_entry,
                                args=(cache, name, key, body))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    entry = aot_cache.load_entry(cache, name, key)
    np.testing.assert_array_equal(entry["probe_logits"], body["probe_logits"])
    assert not [n for n in os.listdir(cache) if n.endswith(".tmp")]


def test_zoo_readmits_with_zero_compiles(tmp_path):
    """Every admission after a tenant's first imports the shared cache, and
    a tenant's engine answers bit for bit a cold engine's."""
    cache = str(tmp_path / "aot")
    specs = [TenantSpec(n, buckets=(1, 4)) for n in ("LeNet", "MobileNet")]
    zoo = ModelZooServer(specs, max_resident=1, eager=False,
                         compute_dtype=torch.float32, device="cpu",
                         aot_cache_dir=cache)
    x = _images(3, seed=4)
    try:
        first = {}
        for cycle in range(2):
            for name in ("LeNet", "MobileNet"):
                got = zoo.predict(x, model=name)
                eng = zoo._tenants[name].engine
                counts = (eng.compile_count, eng.aot_cache_hits)
                assert counts == ((2, 0) if cycle == 0 else (0, 2)), \
                    (name, cycle, counts)
                first.setdefault(name, got)
                np.testing.assert_array_equal(got, first[name])
        assert zoo.stats["admissions"] == 4
        health = zoo.health()["tenants"]["MobileNet"]
        assert health["compiles"] == 0 and health["aot_cache_hits"] == 2
    finally:
        zoo.close()
    for name in ("LeNet", "MobileNet"):
        cold = InferenceEngine.from_random(name, buckets=(1, 4), **KW)
        np.testing.assert_array_equal(cold.predict(x), first[name])


@pytest.mark.parametrize("int8", [False, True])
def test_an_imported_weight_set_is_freed_without_a_collection(tmp_path,
                                                              int8):
    """The zoo's eviction frees an engine by its references alone (its
    memory check runs with the collector off): no reference cycle may hold
    an imported weight set."""
    import gc
    import weakref

    cache = str(tmp_path / "aot")
    kw = dict(buckets=(1, 4), aot_cache_dir=cache, int8=int8, **KW)
    InferenceEngine.from_random("MobileNet", **kw)
    gc.collect()
    gc.disable()
    try:
        eng = InferenceEngine.from_random("MobileNet", **kw)
        assert eng.aot_cache_hits == 2
        leaves = []
        _tree_leaves(eng._weights[1], leaves)
        refs = [weakref.ref(t) for t in leaves]
        del eng, leaves
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def _tree_leaves(tree, out):
    from pytorch_cifar_tpu_torch.serve.engine import _tree_map

    def add(leaf):
        for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            if isinstance(t, torch.Tensor):
                out.append(t)
        return leaf

    _tree_map(add, tree)


def test_a_weight_set_named_by_its_bytes(tmp_path):
    """An engine given a ``state_dict`` with nothing else naming it (the
    JAX trees, a reference ``.pth``) keys its entries by the bytes' digest:
    the same weights hit, other weights miss."""
    cache = str(tmp_path / "aot")
    sd = InferenceEngine.from_random("LeNet", buckets=(1,), **KW) \
        .weights_host()
    kw = dict(buckets=(1, 4), aot_cache_dir=cache, **KW)
    e1 = InferenceEngine("LeNet", sd, **kw)
    e2 = InferenceEngine("LeNet", sd, **kw)
    assert (e1.compile_count, e2.compile_count, e2.aot_cache_hits) == \
        (2, 0, 2)
    assert e2._cache_key_fields(None)["weights"] == {
        "sha256": state_digest(sd)}
    other = dict(sd, **{k: v + 1 for k, v in sd.items()
                        if k.endswith("bias")})
    e3 = InferenceEngine("LeNet", other, **kw)
    assert (e3.compile_count, e3.aot_cache_misses) == (2, 2)
    x = _images(4, seed=6)
    np.testing.assert_array_equal(e2.predict(x), e1.predict(x))


def test_cold_start_tool_splits_a_start_and_hits_the_second(tmp_path,
                                                            capsys):
    """``tools/cold_start.py`` (what ``chip_smoke.py``'s ``cold_start``
    phase runs in fresh processes): both lanes prepared, then imported
    with every bucket's bits equal; a zoo's re-admissions import."""
    from pytorch_cifar_tpu_torch.tools import cold_start

    argv = ["--device", "cpu", "--dtype", "float32", "--model", "LeNet",
            "--buckets", "1", "4", "--lanes", "fp", "int8",
            "--aot_cache", str(tmp_path / "aot")]
    recs = []
    for _ in range(2):
        assert cold_start.main(argv) == 0
        recs.append(json.loads(capsys.readouterr().out))
    for lane in ("fp", "int8"):
        miss, hit = (r["engines"][lane] for r in recs)
        assert (miss["compiles"], miss["aot_cache_misses"]) == (2, 2)
        assert (hit["compiles"], hit["aot_cache_hits"]) == (0, 2)
        assert hit["bits"] == miss["bits"] and len(hit["bits"]) == 2
        assert {"checkpoint_read_ms", "decode_ms"}.isdisjoint(
            miss["stages"])  # seeded weights: no checkpoint to read
        assert "init_ms" in miss["stages"]
        assert set(hit["stages"]) == {"cache_read_ms", "cache_put_ms",
                                      "model_ms", "b1_first_ms",
                                      "b4_first_ms"}
        assert hit["ready_s"] >= hit["cold_start_s"] > 0.0
    assert "int8_plan_ms" in recs[0]["engines"]["int8"]["stages"]
    assert "import_torch_ms" in recs[1]["process_stages"]
    assert cold_start.main(["--device", "cpu", "--dtype", "float32",
                            "--buckets", "1", "4", "--zoo",
                            "LeNet,MobileNet", "--cycles", "2",
                            "--aot_cache", str(tmp_path / "zoo")]) == 0
    zoo = json.loads(capsys.readouterr().out)
    assert [(a["model"], a["compiles"], a["aot_cache_hits"])
            for a in zoo["admissions"]] == [
        ("LeNet", 2, 0), ("MobileNet", 2, 0), ("LeNet", 0, 2),
        ("MobileNet", 0, 2)]
    assert zoo["bits_stable"] == {"LeNet": True, "MobileNet": True}
