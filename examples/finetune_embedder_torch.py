"""Fine-tune the cache embedder with the PyTorch/CUDA port — the port of
``examples/finetune_embedder.py`` (the paper's training recipe).

    PYTHONPATH=src python examples/finetune_embedder_torch.py --full   # card
    PYTHONPATH=src python examples/finetune_embedder_torch.py \\
        --device cpu                                                  # CPU

Defaults to the reduced smoke config (2 layers, d_model 128); ``--full``
selects the published ``modernbert-149m`` widths (22 layers, d_model
768, ~149M parameters).  On a card the online contrastive loss and its
gradient run the hand-written CUDA kernels; on the CPU their plain torch
versions.  The encoder starts from seeded weights (no published weights
ship with the repo).  Saving a checkpoint (the reference's ``--out``)
arrives with the port's checkpoint format.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core import EmbedderTrainer, FinetuneConfig
from repro_torch.data import HashTokenizer, make_pair_dataset


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--domain", default="medical",
                    choices=["medical", "quora"])
    ap.add_argument("--epochs", type=int, default=1,
                    help="paper recipe: 1 (see §3.2 on forgetting)")
    ap.add_argument("--pairs", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=6.5383156211679e-5,
                    help="paper's exact lr (raised to 5e-4 without --full)")
    ap.add_argument("--clip", type=float, default=0.5)
    ap.add_argument("--loss", default="online",
                    choices=["online", "contrastive"])
    ap.add_argument("--full", action="store_true",
                    help="published 149M widths instead of the smoke size")
    args = ap.parse_args()

    cfg = get_config("modernbert-149m")
    if not args.full:
        cfg = cfg.reduced(vocab_size=4096)
        if args.lr < 1e-4:
            args.lr = 5e-4  # rescale for the 1000x smaller model
    tok = HashTokenizer(vocab_size=cfg.vocab_size)

    train, evl = make_pair_dataset(args.domain, args.pairs, seed=0).split(
        eval_frac=0.15, seed=1)
    ft = FinetuneConfig(epochs=args.epochs, lr=args.lr,
                        batch_size=args.batch_size, max_grad_norm=args.clip,
                        loss=args.loss, max_len=24)
    trainer = EmbedderTrainer(cfg, ft, device=args.device)
    print(f"encoder {cfg.name} on {trainer.device}; {len(train)} training "
          f"pairs, {len(evl)} eval pairs")

    before = trainer.evaluate(evl, tok)
    print("before:", {k: round(v, 4) for k, v in before.items()})
    stats = trainer.fit(train, tok)
    after = trainer.evaluate(evl, tok)
    print(f"trained {stats['steps']} steps in {stats['train_seconds']:.1f}s")
    print("after: ", {k: round(v, 4) for k, v in after.items()})
    print(f"precision {before['precision']:.3f} -> {after['precision']:.3f}, "
          f"AP {before['ap']:.3f} -> {after['ap']:.3f}")


if __name__ == "__main__":
    main()
