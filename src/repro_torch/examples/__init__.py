"""Twins of the repo's ``examples/*.py`` on the port: each runs as
``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu`` is given."""
