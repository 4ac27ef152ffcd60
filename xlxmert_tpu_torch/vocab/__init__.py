"""Visual vocabulary (port of xlxmert_tpu/vocab/)."""
