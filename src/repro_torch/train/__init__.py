"""Training on the port — the counterpart of the reference package's
``train/``: the synthetic data pipeline (``data``), AdamW with its schedule
(``optimizer``), the loss and the train steps — plain, gradient
accumulation and data-parallel over ``torch.distributed`` —
(``train_loop``), compressed gradient all-reduce (``compression``) and
checkpoints in the reference's layout (``checkpoint``)."""
