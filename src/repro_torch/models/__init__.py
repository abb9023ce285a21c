"""The paper's split CNNs and the dense decoder LM."""
from .cnn import (CIFAR_CNN, MNIST_CNN, APHead, ClientCNN, CNNConfig,
                  StackedAPHead, StackedClientCNN, cnn_init, cnn_stacked)
from .config import ModelConfig, reduce_config
from .model import APLM, ClientLM, Model, build_model, build_plan

__all__ = ["APHead", "APLM", "CIFAR_CNN", "CNNConfig", "ClientCNN", "ClientLM", "MNIST_CNN",
           "Model", "ModelConfig", "StackedAPHead", "StackedClientCNN", "build_model",
           "build_plan", "cnn_init", "cnn_stacked", "reduce_config"]
