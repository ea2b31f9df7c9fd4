from .loader import LMBatchLoader, make_corpus_tokens  # noqa: F401
from .tokenizer import ByteTokenizer  # noqa: F401
