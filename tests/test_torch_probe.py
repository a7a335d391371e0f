"""The port's dense query probe on a non-PS parameter set against the
reference's (tests/test_probe_and_peqt.py::test_dense_probe_non_ps's set,
N=128, C=2): the same seeded DB, query and mask give the same counts, levels
and noise budget, and every planted match decrypts exactly."""

import numpy as np

from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.engine.probe import dense_query_probe as ref_probe
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.engine.probe import dense_query_probe

NON_PS = {
    "table_params": {"hash_func_count": 1, "table_size": 32, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 5, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 128,
                    "coeff_modulus_bits": [40, 40, 30]},
}


def test_dense_probe_non_ps_matches_reference():
    want = ref_probe(RefParams.from_dict(NON_PS), np.random.default_rng(2), n_caches=2)
    got = dense_query_probe(PSUParams.from_dict(NON_PS), np.random.default_rng(2), n_caches=2,
                            device="cpu")
    assert got.exact and got.n_matched > 0 and got.n_false == 0
    assert got == type(got)(**vars(want))
