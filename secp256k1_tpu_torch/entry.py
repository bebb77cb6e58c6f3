"""Entry points: the flagship step and a multi-device dry run.

`entry()` returns the batched ECDSA verify core (hash scalars, signatures
and public keys in, a status a lane out) with example planes on the card.

`dryrun_multichip(n)` starts n ranks, processes of this module on the CPU
joined by gloo, and runs both sharded paths once on tiny shapes in each:
data-parallel batch verify and the sharded Pippenger MSM (each rank's
window sums all-gathered and reduced by a tree of point adds).  The test
scaffolding (the signature, the expected sum) is python-int arithmetic.

    N_DEVICES=8 python -m secp256k1_tpu_torch.entry
"""

from __future__ import annotations

import argparse
import hashlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .models import ecdsa
from .models.rfc6979 import DrbgRFC6979
from .ops import limbs as lb
from .ops import point as pt
from .parallel import mesh as meshmod
from .parallel import sharded
from .utils import batching as bt
from .utils import errors as ec
from .utils import hostcurve as hc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120


def entry(device=None):
    """(fn, example_args): `ecdsa._verify_core` and (qx, qy, e, r, s)
    planes of 1,024 lanes on `device` (None: the GPU, which must be
    present): the public key G on every lane, random e, r and s below
    2^255."""
    dev = bt.resolve_device(device)
    b = bt.bucket(1024)
    rng = np.random.default_rng(0)

    def mk():
        x = rng.integers(0, 1 << 16, size=(16, b)).astype(np.int32)
        x[15] &= 0x7FFF
        return torch.as_tensor(x, device=dev)

    qx = bt.plane([hc.GX], b, fill=hc.GX, device=dev)
    qy = bt.plane([hc.GY], b, fill=hc.GY, device=dev)
    return ecdsa._verify_core, (qx, qy, mk(), mk(), mk())


def _host_sign_rfc6979(d: int, digest: bytes):
    """Deterministic low-s ECDSA signature (e, r, s) in python ints, the
    host oracle of the dry run."""
    e = int.from_bytes(digest[:32], "big") % hc.N
    drbg = DrbgRFC6979(d.to_bytes(32, "big"), e.to_bytes(32, "big"))
    while True:
        k = int.from_bytes(drbg.read(32), "big")
        if not 1 <= k < hc.N:
            continue
        rx, _ = hc.mul(k, hc.G)
        r = rx % hc.N
        s = pow(k, -1, hc.N) * (e + r * d) % hc.N
        if r == 0 or s == 0:
            continue
        if s > hc.N // 2:
            s = hc.N - s
        return e, r, s


def _rank_main(rank: int, world: int, port: int) -> None:
    """One rank of the dry run: both sharded paths on the CPU."""
    torch.set_num_threads(1)
    meshmod.init_distributed(device="cpu",
                             init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
    try:
        mesh = meshmod.data_mesh(world)

        # Data-parallel verify: one host-signed signature on 2n lanes.
        b = 2 * world
        d_priv = 0xC0FFEE
        pub = hc.mul(d_priv, hc.G)
        e_i, r_i, s_i = _host_sign_rfc6979(
            d_priv, hashlib.sha256(b"graft dryrun").digest())

        def plane(v):
            return torch.as_tensor(lb.int_to_limbs_batch([v] * b),
                                   dtype=lb.DTYPE)

        args = (plane(pub[0]), plane(pub[1]), plane(e_i), plane(r_i),
                plane(s_i))
        shards = meshmod.shard_batch(mesh, args)
        back = meshmod.gather_batch(mesh, shards)
        assert all(torch.equal(x, y) for x, y in zip(back, args))
        verify = sharded.sharded_verify_fn(mesh)
        status = meshmod.gather_batch(mesh, verify(*shards))
        assert status.shape == (b,) and (status == ec.OK).all(), status
        bad = shards[:3] + (meshmod.shard_batch(
            mesh, plane((r_i + 1) % hc.N)),) + shards[4:]
        bad_status = meshmod.gather_batch(mesh, verify(*bad))
        assert (bad_status != ec.OK).all(), bad_status

        # Sharded Pippenger MSM: 4n points, w = 2 (the sort + scan path).
        n_points = 4 * world
        ks = [(i * 7 + 1) % hc.N for i in range(n_points)]
        pts = [hc.mul(i + 1, hc.G) for i in range(n_points)]
        scalars = torch.as_tensor(lb.int_to_limbs_batch(ks), dtype=lb.DTYPE)
        points = pt.from_affine_ints(pts, device="cpu")
        meshmod.barrier("msm")
        result = sharded.sharded_msm(mesh, *meshmod.shard_batch(
            mesh, (scalars, points)), window_bits=2)
        rx, rz = (lb.limbs_to_int(c.reshape(16)) for c in (result.x,
                                                            result.z))
        want = None
        for k, p in zip(ks, pts):
            want = hc.add(want, hc.mul(k, p))
        assert rx * pow(rz, hc.P - 2, hc.P) % hc.P == want[0]
        if rank == 0:
            print(f"dryrun_multichip({world}): verify + sharded MSM OK",
                  flush=True)
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> None:
    """Run both sharded paths once on n_devices gloo ranks on the CPU, each
    rank a process of this module (`--rank`), all within RANK_TIMEOUT_S;
    on a failure every rank is killed and the failed ranks' output raised.
    Prints rank 0's output."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "secp256k1_tpu_torch.entry", "--rank",
         str(i), "--world", str(n_devices), "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n_devices)]
    outs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0))[0])
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"dryrun_multichip({n_devices}): a rank ran "
                           f"past {RANK_TIMEOUT_S} s") from exc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [i for i, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): ranks {failed} failed:\n"
            + "\n".join(f"--- rank {i} (exit {procs[i].returncode}):\n"
                        f"{outs[i]}" for i in failed))
    print(outs[0], end="", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--port", type=int)
    args = parser.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(int(os.environ.get("N_DEVICES", "8")))
    else:
        _rank_main(args.rank, args.world, args.port)


if __name__ == "__main__":
    main()
