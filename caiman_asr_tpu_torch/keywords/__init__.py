from caiman_asr_tpu_torch.keywords.trie import Keywords
from caiman_asr_tpu_torch.keywords.process import load_keywords

__all__ = ["Keywords", "load_keywords"]
