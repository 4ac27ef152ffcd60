"""Host-side input: tokenizer, json and grid-feature h5 readers."""
