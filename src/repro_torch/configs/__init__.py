"""Configurations: the paper's SNN networks (Table II) and the LM registry
(``base.get_config``; ``rwkv6-7b`` is the ported LM)."""
