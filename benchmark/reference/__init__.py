"""The plain reference of the benchmark: what a correct query response holds.

It imports nothing of the program under test (``apsu_tpu_torch``) and
nothing of the JAX package; only numpy, torch and ``cryptography``.  It
works every expected value out again from the inputs the harness made:

* ``ring``: negacyclic transforms, BFV decryption and the batch decoding of
  the slots, in plain int64 PyTorch (on whatever device it is given);
* ``matching``: the matching polynomial ∏(x − r) of every (bundle, cache,
  lane) and the receiver's mask draws (the AES-CTR stream of its keyed RNG);
* ``placement``: frozen copies of the item hashing that decides where an
  item lands (the cuckoo location functions, the debug OPRF, the felt split,
  the sender's cuckoo table) and the receiver's bins built from them.
"""
