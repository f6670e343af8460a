"""Wolf-KV: the paper's block manager driving a paged KV cache."""
