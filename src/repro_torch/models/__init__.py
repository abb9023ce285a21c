"""The paper's split CNNs and the decoder LMs (and their cluster-stacked
forms)."""
from .cnn import (CIFAR_CNN, MNIST_CNN, APHead, ClientCNN, CNNConfig,
                  StackedAPHead, StackedClientCNN, cnn_init, cnn_stacked)
from .config import ModelConfig, reduce_config
from .model import (APLM, ClientLM, Model, StackedAPLM, StackedClientLM, StackedModel,
                    build_model, build_plan, build_stacked_model)

__all__ = ["APHead", "APLM", "CIFAR_CNN", "CNNConfig", "ClientCNN", "ClientLM", "MNIST_CNN",
           "Model", "ModelConfig", "StackedAPHead", "StackedAPLM", "StackedClientCNN",
           "StackedClientLM", "StackedModel", "build_model", "build_plan",
           "build_stacked_model", "cnn_init", "cnn_stacked", "reduce_config"]
