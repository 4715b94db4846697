from .flash_attention import attention_plain, flash_attention
