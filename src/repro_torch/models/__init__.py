"""The paper's split CNNs and the LMs of every family, the encoder-decoder
included (and their cluster-stacked forms)."""
from .cnn import (CIFAR_CNN, MNIST_CNN, APHead, ClientCNN, CNNConfig,
                  StackedAPHead, StackedClientCNN, cnn_init, cnn_stacked)
from .config import ModelConfig, reduce_config
from .model import (APLM, ClientLM, Encoder, Model, StackedAPLM, StackedClientLM,
                    StackedModel, build_model, build_plan, build_stacked_model)

__all__ = ["APHead", "APLM", "CIFAR_CNN", "CNNConfig", "ClientCNN", "ClientLM", "Encoder",
           "MNIST_CNN", "Model", "ModelConfig", "StackedAPHead", "StackedAPLM",
           "StackedClientCNN", "StackedClientLM", "StackedModel", "build_model", "build_plan",
           "build_stacked_model", "cnn_init", "cnn_stacked", "reduce_config"]
