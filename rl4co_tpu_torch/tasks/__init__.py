from rl4co_tpu_torch.tasks.eval import evaluate_policy, EVAL_METHODS  # noqa: F401
