"""The paper's simulator networks at their published widths."""

from .dnn import NETWORKS, har_net, mnist_net, okg_net
