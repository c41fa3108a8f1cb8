"""Model configuration, RoPE and the dense Llama/Qwen3 forward."""
