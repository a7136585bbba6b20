from .train import make_lm_train_step  # noqa: F401
