from .metrics import sad, mse, grad_error, conn_error, evaluate  # noqa: F401
