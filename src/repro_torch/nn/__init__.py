from repro_torch.nn.layers import Dense, dense_apply, dense_init

__all__ = ["Dense", "dense_apply", "dense_init"]
