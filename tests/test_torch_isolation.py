"""The port stands alone and never hides the device.

- Every module of `secp256k1_tpu_torch` imports without JAX and without the
  JAX package (checked in a fresh interpreter).
- Entry points default to the GPU and raise when there is none; only
  `device="cpu"` runs the plain path (the flagship step `entry()` and
  `init_distributed` too).
- A kernel wrapper takes the plain version only for CPU tensors.
- `chip_smoke.py` fails, and prints no result, without a GPU or outside a
  checkout.
- The plain references of Taproot verify import nothing of JAX, the JAX
  package or the port (read with `ast`).
"""

import ast
import json
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import secp256k1_tpu_torch
from secp256k1_tpu_torch import native
from secp256k1_tpu_torch.models import ecdh, ecdsa, keys, schnorr
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops.cuda import build
from secp256k1_tpu_torch.ops.cuda import kernels as K
from secp256k1_tpu_torch.utils import batching as bt

# One intra-op thread: tier-1 runs several pytest workers on one host,
# and a thread pool of the cores' size in each would oversubscribe it.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        secp256k1_tpu_torch.__path__, "secp256k1_tpu_torch."))


def _run(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _modules()
    for m in ("models.ecdsa", "models.schnorr", "models.keys",
              "models.rfc6979", "models.tuplehash", "models.ecdh", "native",
              "utils.config", "ops.cuda.kernels", "ops.msm", "ops.table",
              "ops.point", "ops.glv", "ops.swu", "models.h2c",
              "models.bitcoin", "models.service", "convert",
              "parallel.mesh", "parallel.sharded", "utils.profiling",
              "entry"):
        assert f"secp256k1_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'secp256k1_tpu' or "
        "m.startswith('secp256k1_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _need_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_entry_points_raise_without_a_gpu():
    _need_no_gpu()
    pubs = np.zeros((1, 33), np.uint8)
    digs = np.zeros((1, 32), np.uint8)
    sigs = np.zeros((1, 8), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ecdsa.verify_batch_arrays(pubs, digs, sigs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ecdsa.verify_raw_batch_status([(1, 2)], [bytes(32)], [(1, 1)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bt.plane([1, 2], 16)
    assert bt.resolve_device("cpu") == torch.device("cpu")


def test_signing_entry_points_raise_without_a_gpu():
    _need_no_gpu()
    keys32 = np.ones((1, 32), np.uint8)
    priv = keys.PrivateKey(5)
    calls = [
        lambda: ecdsa.sign_batch_arrays(keys32, keys32),
        lambda: ecdsa.sign_batch([priv], [bytes(32)]),
        lambda: ecdsa.recover_batch([bytes(32)], [(1, 1, 0)]),
        lambda: ecdsa.PubkeyCache([priv.public_key]),
        lambda: schnorr.sign_batch_arrays(keys32, keys32, keys32),
        lambda: schnorr.verify_batch_arrays(keys32, keys32,
                                            np.ones((1, 64), np.uint8)),
        lambda: schnorr.verify_batch([], [], []),
        lambda: ecdh.ecdh_batch([priv], [priv.public_key]),
        lambda: priv.ecdh(priv.public_key),
        lambda: ecdh.ecdh_batch_arrays(keys32,
                                       np.full((1, 33), 2, np.uint8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_slice_entry_points_raise_without_a_gpu():
    """Hash-to-curve, consensus verify, the wallet signer and the verify
    service."""
    _need_no_gpu()
    from secp256k1_tpu_torch.models import bitcoin, h2c, service
    msgs = np.zeros((1, 4), np.uint8)
    pub = keys.PrivateKey(5).public_key
    calls = [
        lambda: h2c.hash_to_curve_batch([b"m"], b"DST"),
        lambda: h2c.encode_to_curve_batch([b"m"], b"DST"),
        lambda: h2c.hash_to_curve_batch_arrays(msgs, b"DST"),
        lambda: h2c.encode_to_curve_batch_arrays(msgs, b"DST"),
        lambda: h2c.hash_to_curve(b"m", b"DST"),
        lambda: h2c.encode_to_curve(b"m", b"DST"),
        lambda: bitcoin.verify_asn1(pub, bytes(32), bytes(9)),
        lambda: bitcoin.verify_asn1_batch([pub], [bytes(32)], [bytes(9)]),
        lambda: bitcoin.verify_asn1_batch_arrays(
            np.full((1, 33), 2, np.uint8), np.zeros((1, 32), np.uint8),
            np.zeros((1, 9), np.uint8), np.full((1,), 9, np.int32)),
        lambda: bitcoin.sign_der_batch_arrays(np.ones((1, 32), np.uint8),
                                              np.zeros((1, 32), np.uint8)),
        lambda: service.VerifyService(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_taproot_check_raises_without_a_gpu():
    """Taproot consensus verify takes the GPU by default, like the other
    entry points."""
    _need_no_gpu()
    from secp256k1_tpu_torch.models import bitcoin
    rows = np.zeros((1, 32), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bitcoin.verify_taproot_batch_arrays(rows, rows,
                                            np.zeros((1, 65), np.uint8),
                                            np.full((1,), 64, np.int32))


def _imports(path: str) -> set:
    """Top-level names a file imports, read with `ast` (not run), with
    the files of its relative imports followed."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            here = os.path.dirname(path)
            mods = [node.module] if node.module else \
                [a.name for a in node.names]
            for m in mods:
                names |= _imports(os.path.join(here, *m.split(".")) + ".py")
    return names


def test_taproot_references_import_nothing_of_the_program():
    """The plain references of Taproot verify stand apart from what they
    check: neither JAX, the JAX package, the port nor torch."""
    for rel in ("tests/taproot_ref.py", "benchmark/reference/taproot.py"):
        names = _imports(os.path.join(REPO, rel))
        assert "hashlib" in names and "numpy" in names, rel
        assert not names & {"jax", "jaxlib", "secp256k1_tpu",
                            "secp256k1_tpu_torch", "torch"}, (rel, names)


def test_h2c_reference_imports_nothing_of_the_program():
    """The benchmark's plain RFC 9380 reference stands apart from what it
    checks: neither JAX, the JAX package, the port, the tests nor torch."""
    rel = "benchmark/reference/h2c.py"
    names = _imports(os.path.join(REPO, rel))
    assert "hashlib" in names and "numpy" in names, names
    assert not names & {"jax", "jaxlib", "secp256k1_tpu",
                        "secp256k1_tpu_torch", "torch", "tests"}, names


def test_flagship_step_and_sharding_entry_points_raise_without_a_gpu():
    """The flagship step and the sharding's process group."""
    _need_no_gpu()
    from secp256k1_tpu_torch import entry
    from secp256k1_tpu_torch.parallel import mesh as meshmod
    calls = [
        lambda: entry.entry(),
        lambda: meshmod.init_distributed(init_method="tcp://127.0.0.1:1",
                                         world_size=1, rank=0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed g++ build raises; nothing falls back to Python."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.sha256_batch(np.zeros((1, 4), np.uint8))
    assert not os.listdir(tmp_path / "build" / os.listdir(
        tmp_path / "build")[0])


def test_expand_message_xmd_batch_raises_without_the_native_library(
        monkeypatch, tmp_path):
    """The batch expand hashes natively or raises: no per-lane fallback
    (the JAX package falls back to hashlib there)."""
    from secp256k1_tpu_torch.models import h2c
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SRC", str(tmp_path / "missing.cpp"))
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        h2c.expand_message_xmd_batch(np.zeros((2, 4), np.uint8), b"DST", 48)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    a = fe.one((4,), "cpu")
    meta = torch.empty((16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.mod_mul(a, meta, fe.P)
    with pytest.raises(ValueError):
        K.mod_square(meta, fe.P)
    K.reset_counts()
    assert torch.equal(K.mod_pow2k(a, 3, fe.P), a)
    assert K.PLAIN_CALLS["mod_pow2k"] == 1 and K.LAUNCHES["mod_pow2k"] == 0


def test_msm_wrappers_take_the_plain_version_only_on_the_cpu():
    """The MSM path's kernels: plain on CPU tensors, a raise on mixed
    devices, no launch counted for either."""
    from secp256k1_tpu_torch.ops import msm
    from secp256k1_tpu_torch.ops import point as pt
    p = pt.identity((4,), "cpu")
    meta = torch.empty((16, 4), dtype=torch.int32, device="meta")
    digits = torch.zeros((2, 4), dtype=torch.int32)
    K.reset_counts()
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.point_double(meta, meta, p.z)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.msm_bucket_accumulate_all(digits, p.x, p.y, meta, 15)
    assert pt.is_identity(pt.double(pt.add(p, p))).all()
    out = msm.multi_scalar_mult(torch.zeros((16, 4), dtype=torch.int32), p)
    assert pt.is_identity(out).tolist() == [True]
    assert not any(K.LAUNCHES.values())
    assert K.PLAIN_CALLS["point_add"] and K.PLAIN_CALLS["point_double"]


def test_engine_wrappers_take_the_plain_version_only_on_the_cpu():
    """The kernels behind the engine switches: plain on CPU tensors, a
    raise on mixed devices, no launch counted for either."""
    from secp256k1_tpu_torch.ops import point as pt
    p = pt._planes(pt.identity((4,), "cpu"))
    meta = torch.empty((16, 4), dtype=torch.int32, device="meta")
    table = torch.zeros((15, 3, 16, 4), dtype=torch.int32)
    digits = torch.zeros((4,), dtype=torch.int32)
    nibbles = torch.zeros((2, 4), dtype=torch.int32)
    K.reset_counts()
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.point_double4(meta, *p[1:])
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.point_add_mixed(*p, meta, p[0])
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.point_lookup_add(*p, table.to("meta"), digits)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.glv_windowed_mult(nibbles, nibbles, table, table.to("meta"))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        K.glv_windowed_mult_from_points(nibbles, nibbles, p, (meta,) * 3)
    assert pt.is_identity(pt.Point(*K.point_double4(*p))).all()
    assert pt.is_identity(pt.Point(*K.point_lookup_add(*p, table,
                                                       digits))).all()
    assert pt.is_identity(pt.Point(*K.glv_windowed_mult(
        nibbles, nibbles, table, table))).all()
    assert not any(K.LAUNCHES.values())
    assert all(K.PLAIN_CALLS[k] == 1 for k in (
        "point_double4", "point_lookup_add", "glv_windowed_mult"))


def test_build_is_keyed_by_the_sources():
    assert build.sources() == ["base", "bip340", "drbg", "glv", "lookup",
                               "modops", "msm", "point"]
    key = build.source_hash()
    assert key == build.source_hash() and len(key) == 16
    assert build.build_dir().startswith(
        os.path.join(REPO, "build", "secp256k1_tpu_torch"))


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    _need_no_gpu()
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and '"ok"' not in out.stdout
