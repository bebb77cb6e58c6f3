"""pytest settings of the tests under tests/ that tests/conftest.py does not
hold: a time limit on every test, and the `slow` and `time_limit` marks of
the JAX package's own tests, given here by node id so that those test files
stay as they are.

A test under tests/ runs under the seconds of its `time_limit` mark, else
SLOW_TIME_LIMIT_S if it is marked `slow`, else TIME_LIMIT_S, for setup, call
and teardown together.  Each is three times the slowest time, on a cold
compilation cache, of the tests it applies to.  When the limit runs out,
faulthandler's own thread prints every thread's stack and exits the process:
a signal handler in Python could not interrupt an XLA compile in C++.  Under
xdist the test is reported failed, the worker is replaced and the run goes
on; without xdist the run ends there.
"""
import faulthandler
import os
import tempfile

import pytest

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
TIME_LIMIT_S = 210          # TestModRing::test_invert[n], 69 s cold
SLOW_TIME_LIMIT_S = 4300    # test_h2c_batch_arrays_matches_object_path, 1,426 s

# Tests of the JAX package that compile a whole pipeline on XLA:CPU, each
# over 60 s cold: by file, the test's name, or its name with the case in [].
# An entry of the file's name alone marks all of its tests.
SLOW = {
    "test_api.py": [
        "test_ecdh_host_matches_device_batch", "test_verify_service",
        "test_verify_service_aggregation_and_backpressure"],
    "test_arrays_e2e.py": [
        "test_verify_batch_arrays_statuses",
        "test_verify_batch_arrays_mixed_encodings_and_wide_digests",
        "test_verify_batch_arrays_reject_malleable",
        "test_verify_batch_arrays_keyed_matches",
        "test_verify_batch_arrays_chunked_matches",
        "test_sign_batch_arrays_matches_per_lane_path",
        "test_sign_batch_arrays_invalid_keys",
        "test_schnorr_verify_batch_arrays_chunked",
        "test_schnorr_sign_batch_arrays_vectors",
        "test_schnorr_sign_batch_arrays_invalid_and_roundtrip",
        "test_ecdh_batch_arrays_matches_and_statuses",
        "test_bitcoin_verify_asn1_batch_arrays",
        "test_verify_service_keyed_cache", "test_verify_service_fast_path"],
    "test_bitcoin_h2c.py": [
        "test_h2c_batch_arrays_matches_object_path", "test_consensus_verify",
        "test_h2c_suite_vectors"],
    "test_ecdsa.py": [
        "test_rfc6979_kat_batch", "test_nonce_reuse_fixed_sigs_verify",
        "test_sign_verify_roundtrip_entropy", "test_low_s_and_reject_malleable",
        "test_recover_public_key"],
    "test_limbs.py": [
        "TestModRing::test_invert_batch", "TestModRing::test_invert_auto[n]"],
    "test_msm.py": [
        "test_pippenger_small", "test_pippenger_zero_scalars",
        "test_pippenger_repeated_digits", "test_straus_matches",
        "test_lane_merge_matches_gold"],
    "test_multiprocess.py": ["test_two_process_sharded_pipelines"],
    "test_native.py": ["test_native_sign_path_matches_python_drbg"],
    "test_pallas_kernels.py": [
        "test_glv_mega_from_points_kernel",
        "test_msm_bucket_accumulate_all_kernel[unsigned]"],
    "test_parallel.py": [
        "test_sharded_verify_matches", "test_sharded_msm_matches_gold",
        "test_sharded_msm_split_matches_fused", "test_graft_entry_dryrun"],
    "test_scalar_mult.py": [
        "test_scalar_mult_vs_gold", "test_double_scalar_mult_basepoint"],
    "test_schnorr.py": [
        "test_bip0340_vectors_verify_batch", "test_schnorr_roundtrip_and_tamper"],
    "test_wycheproof.py": [],
}
# Tests with a limit of their own, in seconds, by file and name.
TIME_LIMIT = {
    # The first test of its file in tier-1 to sign and verify: it compiles
    # both pipelines, 404 s cold, and the tests after it reuse them.
    "test_ecdsa.py": {"test_self_verify_option": 1215},
}

DUMP_FD = pytest.StashKey[int]()
STARTED = pytest.StashKey[str]()


def _in_tests(item):
    return str(item.path).startswith(TESTS + os.sep)


def _matches(name, entry):
    return name == entry or name.split("[")[0] == entry


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Mark before `-m` deselects (the mark plugin's hook runs later)."""
    for item in items:
        if not _in_tests(item):
            continue
        fname, name = item.path.name, item.nodeid.split("::", 1)[-1]
        if fname in SLOW and (not SLOW[fname] or any(
                _matches(name, e) for e in SLOW[fname])):
            item.add_marker(pytest.mark.slow)
        for entry, limit in TIME_LIMIT.get(fname, {}).items():
            if _matches(name, entry):
                item.add_marker(pytest.mark.time_limit(limit))


def pytest_configure(config):
    # The real stderr, kept before capture takes fd 2 during a test.
    config.stash[DUMP_FD] = os.dup(2)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    """Give every xdist worker the file in which workers note each test
    they start."""
    config = node.config
    if STARTED not in config.stash:
        fd, config.stash[STARTED] = tempfile.mkstemp(prefix="started-tests-")
        os.close(fd)
    node.workerinput["started_tests"] = config.stash[STARTED]


def pytest_unconfigure(config):
    if STARTED in config.stash:
        os.unlink(config.stash[STARTED])


def _started_before(item):
    """Whether a worker started this test before: one the limit took down
    with it, that xdist has queued again.  Notes the test as started."""
    path = getattr(item.config, "workerinput", {}).get("started_tests")
    if path is None:
        return False
    with open(path) as fh:
        if item.nodeid in fh.read().splitlines():
            return True
    with open(path, "a") as fh:
        fh.write(item.nodeid + "\n")
    return False


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item):
    if not _in_tests(item):
        yield
        return
    if _started_before(item):
        item.add_marker(pytest.mark.skip(
            reason="took a worker down before and was reported failed"))
    mark = item.get_closest_marker("time_limit")
    if mark:
        limit = mark.args[0]
    elif item.get_closest_marker("slow"):
        limit = SLOW_TIME_LIMIT_S
    else:
        limit = TIME_LIMIT_S
    faulthandler.dump_traceback_later(limit, exit=True,
                                      file=item.config.stash[DUMP_FD])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
