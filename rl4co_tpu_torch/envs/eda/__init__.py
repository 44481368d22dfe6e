from rl4co_tpu_torch.envs.eda.dpp import DPP, MDPP, DPPState  # noqa: F401
