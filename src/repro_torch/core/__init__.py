"""The paper's primary contribution: the semantic cache — embedding
model + vector store + threshold policy — plus its training objective
(online contrastive loss), fine-tuning recipe, evaluation metrics and
the synthetic data pipeline; the baseline embedders; the IVF index and
threshold calibration of the tiered cache."""
from repro_torch.core.cache import SemanticCache
from repro_torch.core.calibration import (
    Calibration, calibrate_for_false_hit_budget, calibrate_for_precision,
)
from repro_torch.core.embedders import (
    EncoderEmbedder, HashNgramEmbedder, RandomProjectionEmbedder,
)
from repro_torch.core.ivf import (
    build_ivf, build_lists, ivf_occupancy, ivf_query, kmeans,
)
from repro_torch.core.losses import (
    contrastive_loss, cosine_distance, hard_pair_fractions,
    online_contrastive_loss,
)
from repro_torch.core.metrics import (
    average_precision, metrics_at_threshold, pair_classification_metrics,
)
from repro_torch.core.store import (
    QueryResult, StoreState, evict_older_than, init_store, insert,
    insert_batch, occupancy, query, touch,
)
from repro_torch.core.synth import (
    LLMGenerator, SynthRecord, TemplateGenerator, export_jsonl,
    generate_synthetic_pairs, import_jsonl, records_to_dataset,
)
from repro_torch.core.trainer import EmbedderTrainer, FinetuneConfig

__all__ = [
    "SemanticCache", "Calibration", "calibrate_for_false_hit_budget",
    "calibrate_for_precision", "EncoderEmbedder", "HashNgramEmbedder",
    "RandomProjectionEmbedder", "build_ivf", "build_lists", "ivf_occupancy",
    "ivf_query", "kmeans",
    "contrastive_loss", "cosine_distance", "hard_pair_fractions",
    "online_contrastive_loss", "average_precision", "metrics_at_threshold",
    "pair_classification_metrics", "QueryResult", "StoreState",
    "evict_older_than", "init_store", "insert", "insert_batch", "occupancy",
    "query", "touch", "LLMGenerator", "SynthRecord", "TemplateGenerator",
    "export_jsonl", "generate_synthetic_pairs", "import_jsonl",
    "records_to_dataset", "EmbedderTrainer", "FinetuneConfig",
]
