"""Worker process for the port's two-process collective check, and
`run_workers`, which starts both ranks and collects their results.

Used by tests/test_torch_multihost.py, tests/test_torch_gpu.py and
chip_smoke.py's mesh phase: two OS processes, each bringing two shards on
one device, join one gloo process group through the port's
parallel/mesh.py::initialize_multihost and run the sharded screen and the
summed elect over the global 4-shard dp mesh, on the inputs of the JAX
package's tests/multihost_worker.py. Each writes its results, and the
inputs (as in_<name>), to <outdir>/proc<rank>.npz. Imports only the port
(and numpy, torch).

Usage: python torch_multihost_worker.py <port> <rank> <outdir> [device]
"""

import os
import socket
import subprocess
import sys

TIMEOUT_S = 120


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(outdir, device="cpu", timeout_s=TIMEOUT_S) -> list[dict]:
    """Start both ranks on 127.0.0.1 with their shards on `device`, wait
    for them, and return each rank's results. A rank that fails raises; at
    the timeout both are killed and it raises."""
    import numpy as np

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(rank),
                          str(outdir), device],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)
    ]
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout_s)
            if p.returncode != 0:
                raise AssertionError(f"rank {rank} exited {p.returncode}:\n"
                                     f"{err.decode(errors='replace')[-3000:]}")
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank did not finish within {timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(os.path.join(outdir, f"proc{r}.npz"))) for r in range(2)]


def inputs():
    """The JAX worker's inputs, identical in every process (rng 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    N, E, L = 16, 10, 64
    ops = rng.choice([1, 1, 1, 3, 2], size=(N, E)).astype(np.uint8)
    ops[:, 0] = 1  # first edit cannot be INSERT (ref_seq.h:24)
    vals = rng.integers(0, 4, (N, E)).astype(np.uint8)
    start = rng.integers(E, L - E, N).astype(np.int32)
    fwd = rng.integers(0, 2, N).astype(bool)
    en = np.ones(N, bool)

    B, LA, LB = 8, 48, 40
    a = rng.integers(0, 4, (B, LA)).astype(np.uint8)
    b = a[:, :LB].copy()
    mut = rng.random((B, LB)) < 0.05
    b = np.where(mut, (b + 1) % 4, b).astype(np.uint8)
    la = np.full(B, LA, np.int32)
    lb = np.full(B, LB, np.int32)
    return dict(ops=ops, vals=vals, start=start, fwd=fwd, en=en, L=L,
                a=a, la=la, b=b, lb=lb, W=13)


def main() -> int:
    port, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from pacbioassembly_tpu_torch.parallel import initialize_multihost, sharded_elect, sharded_screen

    mesh = initialize_multihost(f"127.0.0.1:{port}", 2, rank, devices=[device, device])
    assert mesh.world_size == 2 and mesh.size == 4, mesh
    x = inputs()
    delta = sharded_elect(mesh, x["ops"], x["vals"], x["start"], x["fwd"], x["en"], x["L"])
    scores = sharded_screen(mesh, x["a"], x["la"], x["b"], x["lb"], la_max=x["a"].shape[1],
                            w_max=x["W"], ratio=0.3)
    np.savez(
        os.path.join(outdir, f"proc{rank}.npz"),
        sel=delta.sel.cpu().numpy(), sup=delta.sup.cpu().numpy(),
        total=delta.total.cpu().numpy(),
        **{f: getattr(scores, f).cpu().numpy() for f in scores._fields},
        devices=np.array([str(d) for d in mesh.devices]),
        **{f"in_{k}": np.asarray(v) for k, v in x.items()},
    )
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
