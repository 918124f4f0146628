"""A gene mesh across two processes (the port's counterpart of
tests/test_multihost.py): two ranks joined by torch.distributed over gloo,
each holding two CPU shards of a 4-shard mesh, run the fused route
(fused_results), the host engine (deseq(engine="host") + results(), its
batched fits split between the ranks) and the streamed single-cell route
(fused_sc_results, group QL); every gather is an all_gather.  Rank 0's
results must equal the single-process run's at rtol 1e-8, atol 1e-10.

The test starts the two ranks by running this file as a script:

    python tests/test_torch_multihost.py RANK WORLD PORT OUT_DIR
"""

import os
import socket
import subprocess
import sys

import numpy as np

G, S = 203, 10
TIMEOUT = 300


def _inputs():
    rng = np.random.default_rng(0)
    mu = np.exp(rng.normal(3.0, 1.5, (G, 1))) * np.ones((1, S))
    size = 1.0 / (4.0 / mu[:, :1] + 0.1)
    counts = rng.negative_binomial(size, size / (size + mu)).astype(np.int32)
    labels = np.repeat(["A", "B"], S // 2)
    x = np.column_stack([np.ones(S), (labels == "B").astype(float)])
    return counts, labels, x


def run_all(mesh):
    """The three routes on the fixture, as host arrays keyed by route."""
    import deseq2_tpu_torch as tdt
    from deseq2_tpu_torch.parallel import fused_results, fused_sc_results
    counts, labels, x = _inputs()
    out = {f"fused {k}": np.asarray(v, float) for k, v in fused_results(
        counts, x, two_group=True, mesh=mesh, device="cpu").items()}
    dds = tdt.dataset_from_matrix(counts, {"condition": labels},
                                  "~ condition")
    res = tdt.results(tdt.deseq(dds, engine="host", mesh=mesh,
                                device="cpu"))
    out.update({f"host {c}": np.asarray(res[c], float)
                for c in res.column_names})
    sc = fused_sc_results(counts, cells=(labels == "B").astype(np.int32),
                          n_groups=2, size_factors=np.ones(S), test="LRT",
                          fit_type="glmGamPoi", mesh=mesh, device="cpu")
    out.update({f"sc {k}": np.asarray(v, float) for k, v in sc.items()
                if v is not None})
    return out


def _worker(rank, world, port, out_dir):
    import torch
    import torch.distributed as dist

    from deseq2_tpu_torch.parallel import gene_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = gene_mesh(devices=["cpu", "cpu"],
                         process_group=dist.group.WORLD)
        assert mesh.size == 2 * world
        out = run_all(mesh)
        if rank == 0:
            np.savez(os.path.join(out_dir, "result.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single(tmp_path):
    import torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port), str(tmp_path)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    multi = np.load(tmp_path / "result.npz")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = run_all(None)
    finally:
        torch.set_num_threads(n)
    assert set(multi.files) == set(single)
    for k, v in single.items():
        np.testing.assert_allclose(multi[k], v, rtol=1e-8, atol=1e-10,
                                   equal_nan=True, err_msg=k)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
