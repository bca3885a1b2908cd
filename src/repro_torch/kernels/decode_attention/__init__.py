"""Single-token decode attention over a KV cache: the CUDA kernel
(`kernel`), its plain torch version (`ref`) and the dispatch between
them (`ops`)."""
