"""Assigned-architecture registry: ``get_config("<id>")`` / ``--arch <id>``."""
from importlib import import_module

ARCH_IDS = (
    "chameleon_34b", "chatglm3_6b", "deepseek_7b", "starcoder2_15b",
    "llama3_2_3b", "recurrentgemma_9b", "dbrx_132b", "qwen3_moe_30b_a3b",
    "xlstm_1_3b", "whisper_base",
)

_ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "chatglm3-6b": "chatglm3_6b",
    "deepseek-7b": "deepseek_7b",
    "starcoder2-15b": "starcoder2_15b",
    "llama3.2-3b": "llama3_2_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "dbrx-132b": "dbrx_132b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-base": "whisper_base",
}


def get_config(arch_id: str):
    mod_name = _ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
