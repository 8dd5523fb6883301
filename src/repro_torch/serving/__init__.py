from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.server import (GNNServer, ServeStats,
                                        ServerClosedError,
                                        ServerOverloadedError)

__all__ = ["EmbeddingCache", "GNNServer", "ServeStats",
           "ServerClosedError", "ServerOverloadedError"]
