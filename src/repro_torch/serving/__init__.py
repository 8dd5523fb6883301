from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.server import (GNNServer, ServerClosedError,
                                        ServerOverloadedError)

__all__ = ["EmbeddingCache", "GNNServer", "ServerClosedError",
           "ServerOverloadedError"]
