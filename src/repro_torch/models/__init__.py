"""The paper's split CNNs."""
from .cnn import (CIFAR_CNN, MNIST_CNN, APHead, ClientCNN, CNNConfig,
                  StackedAPHead, StackedClientCNN, cnn_init, cnn_stacked)

__all__ = ["APHead", "CIFAR_CNN", "CNNConfig", "ClientCNN", "MNIST_CNN",
           "StackedAPHead", "StackedClientCNN", "cnn_init", "cnn_stacked"]
