"""The paper's SNN configurations (Table II)."""
