"""OGB molecular categorical feature dimensions (public OGB constants; the
port's own copy of `deep_gcns_torch_tpu/data/ogb_features.py`, from the
reference's feature dictionaries `utils/data_util.py:248-347`)."""

ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
