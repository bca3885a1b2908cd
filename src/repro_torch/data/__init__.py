from repro_torch.data.tokenizer import HashTokenizer, PAD, BOS, EOS, UNK
from repro_torch.data.corpora import (
    DOMAINS, PairDataset, Query, make_pair_dataset, make_query_stream,
    render_query, sample_query,
)
from repro_torch.data.pairs import iter_batches, shard_batch, tokenize_pairs

__all__ = [
    "HashTokenizer", "PAD", "BOS", "EOS", "UNK",
    "DOMAINS", "PairDataset", "Query", "make_pair_dataset",
    "make_query_stream", "render_query", "sample_query",
    "iter_batches", "shard_batch", "tokenize_pairs",
]
