"""BIP-0066 rows shared by the port's tests of the consensus checks.

Every row carries its sighash byte.  `cases()` holds the vector file's
rows, seeded mutations of the valid ones and a few rows at the edges; the
NumPy form and the native pass are both held to the scalar validators on
these same rows.
"""

import json
import os

import numpy as np

TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


def vectors():
    """(valid, invalid) rows of `bip-0066-test-vectors.json`."""
    with open(os.path.join(TESTDATA, "bip-0066-test-vectors.json")) as f:
        data = json.load(f)
    valid = [bytes.fromhex(c["DER"]) + b"\x45" for c in data["valid"]]
    invalid = [bytes.fromhex(c["DER"]) + b"\x45"
               for c in data["invalid"]["decode"]]
    return valid, invalid


def cases():
    """The vectors, 600 seeded mutations of the valid ones (a byte changed,
    a byte cut or added, a length byte off by one), then an empty row, a
    lone tag, 73 zero bytes and a row past BIP-0066's 73 bytes."""
    valid, invalid = vectors()
    rng = np.random.default_rng(66)
    rows = list(valid) + list(invalid)
    for _ in range(600):
        s = bytearray(valid[rng.integers(len(valid))])
        kind = rng.integers(4)
        if kind == 0:
            s[rng.integers(len(s))] = int(rng.integers(256))
        elif kind == 1:
            del s[rng.integers(len(s))]
        elif kind == 2:
            s.insert(int(rng.integers(len(s) + 1)), int(rng.integers(256)))
        else:
            pos = int(rng.choice([1, 3, 5 + s[3]])) if 5 + s[3] < len(s) \
                else 1
            s[pos] = (s[pos] + int(rng.choice([-1, 1]))) % 256
        rows.append(bytes(s))
    return rows + [b"", b"\x30", bytes(73), b"\x30" * 74]
