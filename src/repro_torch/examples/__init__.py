"""The reference's five examples, ported: run each as
``python -m repro_torch.examples.<name>`` (``quickstart``, ``gru_rnn``,
``cnn_im2col``, ``serve_decode``, ``train_lm``), on the card by default or
with ``--device cpu``. Each prints ``OK`` at its end."""
