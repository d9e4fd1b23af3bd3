"""One rank of a two-rank gloo replica on the CPU, as a child process, and
the launcher that runs a pair of them.

``python tests/_torch_mesh.py RANK PORT CACHE_DIR`` joins the pair's
process group on ``127.0.0.1:PORT``, builds ResNet-18 (fp32, buckets 1 and
4) from ITS OWN seed (the rank's: the bootstrap broadcast must make the
follower serve the leader's weights) behind a
:class:`~pytorch_cifar_tpu_torch.serve.mesh_replica.MeshReplica`
(on the cold-start cache ``CACHE_DIR`` unless it is ``-``) and prints one
JSON record. The leader holds every answer against a one-process engine
on seed 0's weights, then swaps both to seed 2's and holds them again;
the follower answers until the leader's shutdown.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (1, 2, 3, 5, 8, 9)


def _state(seed):
    import torch

    from pytorch_cifar_tpu_torch.models import create_model

    model = create_model("ResNet18", generator=torch.Generator().manual_seed(
        seed))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _images(n, seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)


def rank_main(rank: int, port: int, cache: str) -> dict:
    import numpy as np
    import torch

    from pytorch_cifar_tpu_torch.parallel import mesh
    from pytorch_cifar_tpu_torch.serve import InferenceEngine
    from pytorch_cifar_tpu_torch.serve.mesh_replica import MeshReplica

    torch.set_num_threads(2)
    mesh.initialize_distributed(f"127.0.0.1:{port}", 2, rank, device="cpu",
                                timeout_s=60)
    group = mesh.gloo_group(60)
    kw = dict(buckets=(1, 4), compute_dtype=torch.float32, device="cpu")
    eng = InferenceEngine("ResNet18", _state(rank), mesh_group=group,
                          aot_cache_dir=None if cache == "-" else cache,
                          weights_id={"random_seed": rank}, **kw)
    warm = {"compiles": eng.compile_count, "hits": eng.aot_cache_hits}
    replica = MeshReplica(eng, timeout_s=60)
    rec = {"rank": rank, **warm, "buckets": list(eng.buckets),
           "barrier_generation": replica.barrier_generation}
    if rank:
        replica.follower_loop()
        return {**rec, "version": eng.version}
    one = InferenceEngine("ResNet18", _state(0), **kw)
    same = all(np.array_equal(replica.predict(x), one.predict(x))
               for x in (_images(n, seed=n) for n in NS))
    version = replica.swap_weights(_state(2))
    one.swap_weights(_state(2))
    swapped = all(np.array_equal(replica.predict(x), one.predict(x))
                  for x in (_images(n, seed=10 + n) for n in (3, 4)))
    health = replica.mesh_health()
    replica.close()
    return {**rec, "version": eng.version, "swap_version": version,
            "bits_identical": same, "swapped_bits_identical": swapped,
            "health": health}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(cache: str = "-", timeout: float = 120) -> list:
    """Both ranks' records, leader first; asserts each exited 0."""
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         cache], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    recs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            recs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return recs


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(json.dumps(rank_main(int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3])), flush=True)
