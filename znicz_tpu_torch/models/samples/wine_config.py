"""Config module of the Wine sample (the reference's convention: a
``*_config.py`` beside a sample sets leaves of the global ``root`` tree
before the workflow is built, ``python -m znicz_tpu_torch wine
wine_config``)."""

from znicz_tpu_torch.utils.config import root

root.wine.max_epochs = 12
root.wine.learning_rate = 0.5
root.wine.minibatch_size = 10
