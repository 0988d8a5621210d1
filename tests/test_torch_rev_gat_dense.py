"""The port's RevGAT on the band's dense route (K7–K9's plain versions)
against the JAX package: the cases of tests/test_torch_rev_gat.py's
`_check_revgat_against_jax` with destination scores, or with the
per-receiver stabilizer. Kept apart from that file so that the two run on two
test workers. Tolerances are that file's.
"""

import pytest

from test_torch_rev_gat import _check_revgat_against_jax, band_mode  # noqa: F401
from torch_budget import budget  # noqa: F401


@pytest.mark.parametrize("variant,drop", [(dict(use_attn_dst=True), False),
                                          (dict(use_attn_dst=True), True),
                                          (dict(stabilizer="per_receiver"), True)])
def test_revgat_dense_matches_jax(band_mode, variant, drop):
    """RevGAT with destination scores, and with sender-only scores under the
    per-receiver stabilizer, on the band's dense route (K7–K9's plain
    versions) against JAX's on its XLA emulation: loss, logits and every
    gradient, with JAX's own drop keys."""
    _check_revgat_against_jax("band", drop, **variant)
