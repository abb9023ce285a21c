"""The paper's split CNNs."""
from .cnn import (CIFAR_CNN, MNIST_CNN, APHead, ClientCNN, CNNConfig,
                  cnn_init)

__all__ = ["APHead", "CIFAR_CNN", "CNNConfig", "ClientCNN", "MNIST_CNN",
           "cnn_init"]
