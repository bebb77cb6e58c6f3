"""The benchmark's plain reference: secp256k1 in python ints and NumPy.

Nothing here imports torch, JAX or either package of this repository.  It
makes the seeded pools the traffic is cut from and recomputes, from the same
inputs the harness hands to the program, the answers the program must give.
"""
