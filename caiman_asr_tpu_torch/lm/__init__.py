from caiman_asr_tpu_torch.lm.ngram import NGramLM, find_ngram_path

__all__ = ["NGramLM", "find_ngram_path"]
