"""Native (C++) host runtime of the port: built at first use with the host
C++ compiler into the git-ignored xlxmert_tpu_torch/_build/, always with
a Python fallback. See tokenizer.cpp and data/fast_tokenizer.py."""
