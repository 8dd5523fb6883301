from repro_torch.nn.layers import (Dense, dense_apply, dense_init,
                                  softmax_cross_entropy)

__all__ = ["Dense", "dense_apply", "dense_init", "softmax_cross_entropy"]
