"""The port's public surface held to the JAX package's, read from the source.

Every public top-level name of every module of `secp256k1_tpu/` (functions,
classes, assignments, and names bound by `from ... import`, which is how a
module re-exports) and every public member of its classes must exist in the
counterpart module of `secp256k1_tpu_torch/`, unless a row of `EXCEPTIONS`
names it.  The JAX side is read with `ast`, so nothing of JAX is imported
or compiled; the port's modules are imported (nothing builds at import).
A counterpart module has the same dotted name under `secp256k1_tpu_torch`,
except the Pallas package, whose place `ops/cuda/` takes (`MODULE_MAP`).

Each row of `EXCEPTIONS` is (JAX module, names, port names or None, why,
pinning test): the names the port leaves out or renames, one line on why,
and the test (`file::function` under `tests/`) that pins the difference.
To add a row, give all five; the rows are checked too: each name must
still be defined by the JAX module and missing from the port (a renamed
one must exist under its port name), and the pinning test must exist.
`import x` statements are not names of a module's surface; `from x import
y` names are, so a module import bound that way needs a row.

Runs in well under a second.
"""

import ast
import functools
import importlib
import os

import pytest

from secp256k1_tpu_torch.models import ecdsa, rfc6979
from secp256k1_tpu_torch.ops import field as fe
from secp256k1_tpu_torch.ops import point as pt
from secp256k1_tpu_torch.ops import scalar as sc
from secp256k1_tpu_torch.ops import table as tbl
from secp256k1_tpu_torch.utils import batching as bt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "secp256k1_tpu")
TESTS = os.path.join(REPO, "tests")

# The Pallas kernels' place is taken by the CUDA kernels: each entry point
# that reaches `pl.pallas_call` has a wrapper of the same name in
# `ops/cuda/kernels.py` (pinned below by the plain versions held against
# the Pallas bodies).
MODULE_MAP = {"ops.pallas": "ops.cuda",
              "ops.pallas.kernels": "ops.cuda.kernels"}

_NO_JAX = "test_torch_isolation.py::" \
    "test_port_imports_neither_jax_nor_the_jax_package"

EXCEPTIONS = [
    ("native", ("available",), None,
     "no pure-Python fallback to choose: a failed native build raises",
     "test_torch_isolation.py::test_native_build_failure_raises"),
    ("parallel.sharded", ("sharded_verify_jit",), ("sharded_verify_fn",),
     "nothing is jitted: each rank runs the verify core on its slice",
     "test_torch_parallel.py::test_dryrun_multichip_two_ranks"),
    ("parallel.sharded", ("sharded_msm_jit", "sharded_msm_split_jits"),
     ("sharded_msm", "sharded_msm_split"),
     "nothing is jitted: the sharded MSM and its split form are functions",
     "test_torch_parallel.py::test_split_composed_equals_sharded_msm"),
    ("utils.profiling",
     ("HBM_BYTES_PER_POINT_OP", "POINT_ADD_VREG_OPS", "POINT_DBL_VREG_OPS"),
     None,
     "TPU v5e counts; the port's bound_ms counts bytes and products for "
     "the H100",
     "test_torch_api.py::test_roofline_report_gives_the_h100_bound"),
    ("models.ecdh", ("cfg",), None,
     "module import of the config: the entry points take device= in "
     "place of batch_cfg",
     "test_torch_isolation.py::test_signing_entry_points_raise_without_a_gpu"),
    ("models.schnorr", ("cfg",), None,
     "module import of the config: the entry points take device= in "
     "place of batch_cfg",
     "test_torch_isolation.py::test_signing_entry_points_raise_without_a_gpu"),
    ("models.h2c", ("cfg",), None,
     "module import of the config: the entry points take device= in "
     "place of batch_cfg",
     "test_torch_isolation.py::test_slice_entry_points_raise_without_a_gpu"),
    ("ops.glv", ("lax",), None, "module import of JAX", _NO_JAX),
    ("ops.limbs", ("lax",), None, "module import of JAX", _NO_JAX),
    ("ops.modring", ("lax",), None, "module import of JAX", _NO_JAX),
    ("ops.msm", ("lax",), None, "module import of JAX", _NO_JAX),
    ("ops.point", ("lax",), None, "module import of JAX", _NO_JAX),
    ("ops.table", ("lax",), None, "module import of JAX", _NO_JAX),
    ("parallel.mesh", ("Mesh", "NamedSharding", "P"), None,
     "module imports of jax.sharding: a mesh here is a process group",
     "test_torch_parallel.py::"
     "test_data_mesh_raises_without_a_group_or_at_another_size"),
    ("parallel.sharded",
     ("Mesh", "NamedSharding", "P", "lax", "partial", "shard_map"), None,
     "module imports of JAX and of functools for jax.jit",
     _NO_JAX),
    ("utils.batching", ("pk",), None,
     "module import of the Pallas package, whose switch tiles the JAX "
     "planes; the port's are flat",
     "test_torch_batching.py::test_batch_shape_is_flat"),
    ("ops.pallas", ("enabled", "set_enabled"), None,
     "the Pallas switch: a CUDA tensor launches the kernel, a CPU tensor "
     "runs its plain version",
     "test_torch_isolation.py::"
     "test_wrappers_take_the_plain_version_only_on_the_cpu"),
    ("ops.pallas.kernels",
     ("BLK_S", "compatible_shape", "pl", "pltpu", "set_interpret"), None,
     "the TPU grid's layout and Pallas itself: the CUDA kernels take flat "
     "[16, B] planes and build with nvcc",
     "test_torch_field.py::test_plain_mod_kernels_match_pallas_bodies"),
    ("ops.pallas.kernels",
     ("B3", "MASK", "NLIMBS", "fadd", "fcanon", "fmul", "fmulw", "fneg",
      "fsqr", "fsub"), None,
     "the Pallas bodies' field core: the CUDA kernels' is csrc/field.cuh",
     "test_torch_csrc_host.py::test_field_cores_match_python_ints"),
    ("ops.pallas.kernels",
     ("lazy_enabled", "set_lazy", "set_f32", "set_f32_point", "use_f32",
      "set_mulv", "set_mock_field"), None,
     "TPU field-core variants (VPU float products, lazy carries, a mock "
     "field for timing); the CUDA core's policies are template arguments",
     "test_torch_csrc_host.py::test_field_cores_match_python_ints"),
]

def _jax_modules():
    mods = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)
                parts = rel[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                mods.append(".".join(parts))
    return sorted(mods)


def _source(mod):
    base = os.path.join(JAX_ROOT, *mod.split(".")) if mod else JAX_ROOT
    return os.path.join(base, "__init__.py") if os.path.isdir(base) \
        else base + ".py"


def _public(name):
    return not name.startswith("_")


def _bound(stmt):
    """The names a module- or class-level statement binds."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [stmt.name]
    if isinstance(stmt, ast.Assign):
        return [n.id for t in stmt.targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return [stmt.target.id]
    if isinstance(stmt, ast.ImportFrom) and stmt.module != "__future__":
        return [a.asname or a.name for a in stmt.names]
    return []


def _statements(body):
    """The statements of a body, with those inside top-level if / try /
    with blocks (not inside functions or classes)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.If, ast.Try, ast.With)):
            blocks = [stmt.body, getattr(stmt, "orelse", []),
                      getattr(stmt, "finalbody", [])]
            blocks += [h.body for h in getattr(stmt, "handlers", [])]
            for block in blocks:
                yield from _statements(block)


@functools.cache
def jax_surface(mod):
    """{public name: set of public class members, or None} of a JAX
    module, from its source."""
    with open(_source(mod)) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for stmt in _statements(tree.body):
        for name in _bound(stmt):
            if not _public(name):
                continue
            members = None
            if isinstance(stmt, ast.ClassDef):
                members = {m for s in stmt.body for m in _bound(s)
                           if _public(m)}
            out[name] = members
    return out


def _excepted(mod):
    out = {}
    for jmod, names, port_names, _, _ in EXCEPTIONS:
        if jmod == mod:
            for i, name in enumerate(names):
                out[name] = port_names[i] if port_names else None
    return out


def port_module(mod):
    return importlib.import_module(
        "secp256k1_tpu_torch" + ("." if mod else "")
        + MODULE_MAP.get(mod, mod))


def missing_names(mod):
    """The JAX module's public names and class members that its port
    lacks and no exception row covers, as 'module.name' strings."""
    port = port_module(mod)
    excepted = _excepted(mod)
    missing = []
    for name, members in sorted(jax_surface(mod).items()):
        if name in excepted:
            continue
        if not hasattr(port, name):
            missing.append(f"{mod}.{name}")
            continue
        for member in sorted(members or ()):
            if not hasattr(getattr(port, name), member):
                missing.append(f"{mod}.{name}.{member}")
    return missing


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_jax_name_has_its_port(mod):
    assert missing_names(mod) == []


def _test_exists(ref):
    path, func = ref.split("::")
    with open(os.path.join(TESTS, path)) as fh:
        tree = ast.parse(fh.read())
    return any(isinstance(s, ast.FunctionDef) and s.name == func
               for s in tree.body)


@pytest.mark.parametrize("row", EXCEPTIONS,
                         ids=[f"{r[0]}:{r[1][0]}" for r in EXCEPTIONS])
def test_every_exception_is_needed_and_pinned(row):
    mod, names, port_names, why, pin = row
    assert why.strip() and _test_exists(pin), pin
    port = port_module(mod)
    for i, name in enumerate(names):
        assert name in jax_surface(mod), f"{mod}.{name} is gone from JAX"
        assert not hasattr(port, name), f"the port has {mod}.{name} now"
        if port_names:
            assert hasattr(port, port_names[i]), port_names[i]


def test_the_pallas_entry_points_have_their_wrappers():
    """Each function of the Pallas kernels module that reaches
    `pl.pallas_call` (directly or through another function there) is a
    wrapper in ops/cuda/kernels.py: the fourteen TPU kernels."""
    with open(_source("ops.pallas.kernels")) as fh:
        tree = ast.parse(fh.read())
    funcs = {s.name: s for s in tree.body if isinstance(s, ast.FunctionDef)}

    def uses(fn):
        return {n.attr if isinstance(n, ast.Attribute) else n.id
                for n in ast.walk(fn)
                if isinstance(n, (ast.Attribute, ast.Name))}

    reach = {name for name, fn in funcs.items()
             if "pallas_call" in uses(fn)}
    while True:
        more = {name for name, fn in funcs.items()
                if name not in reach and uses(fn) & reach}
        if not more:
            break
        reach |= more
    kernels = sorted(name for name in reach if _public(name))
    assert len(kernels) == 14, kernels
    port = port_module("ops.pallas.kernels")
    assert [k for k in kernels if not callable(getattr(port, k, None))] == []


def test_a_removed_name_is_reported(monkeypatch):
    """The check fails when the port loses a name the JAX package has."""
    assert missing_names("ops.field") == []
    monkeypatch.delattr(fe, "pow_const")
    monkeypatch.delattr(pt.Point, "batch_shape")
    assert missing_names("ops.field") == ["ops.field.pow_const"]
    assert missing_names("ops.point") == ["ops.point.Point.batch_shape"]


def test_module_aliases_are_the_ring_methods():
    """The aliases of field and scalar are the ring's own bound methods
    (a bound method is made anew at each access, so `is` compares its
    function and its ring)."""
    for mod, ring in ((fe, fe.F), (sc, sc.S)):
        names = ["pow_const", "bytes_are_canonical", "from_wide_bytes"]
        for name in names:
            alias = getattr(mod, name)
            assert alias.__self__ is ring, name
            assert alias.__func__ is getattr(type(ring), name), name
    assert ecdsa.DrbgRFC6979 is rfc6979.DrbgRFC6979
    assert tbl.P == fe.P and bt.batch_shape(8) == (8,)
