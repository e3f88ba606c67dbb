"""The port's example CLIs, one per reference workload and the
transformer LM; each runs as ``python -m
distributed_tensorflow_examples_tpu_torch.examples.<name>``."""

__all__ = ["cifar10_cnn", "mnist_mlp", "ptb_lstm", "resnet50", "transformer_lm", "word2vec"]
