"""Streaming cosine top-k of the flat cache: the CUDA kernel (`kernel`),
its plain torch version (`ref`) and the dispatch between them (`ops`)."""
