"""LXMERT backbone and task models (bf16 serving and exact fp32)."""
