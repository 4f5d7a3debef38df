"""Configurations: the paper's SNN networks (Table II) and the LM registry
(``base.get_config``: the reference's ten LMs)."""
