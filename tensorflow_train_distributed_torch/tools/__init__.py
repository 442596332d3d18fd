"""The port's bench and trace tools, the counterparts of the repository
root's ``bench.py`` and ``tools/``: each runs as
``python -m tensorflow_train_distributed_torch.tools.<name>``, on the card
by default (``--device cpu`` for a CPU run that measures no device).
``roofline`` holds the formulas they and ``chip_smoke.py`` share."""
