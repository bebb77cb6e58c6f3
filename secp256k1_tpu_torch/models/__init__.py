"""The port's entry-point modules, as the package exports them."""

from . import bitcoin, codecs, ecdh, ecdsa, h2c, keys, schnorr  # noqa: F401
