from .rwkv_tokenizer import RwkvTokenizer, load_tokenizer  # noqa: F401
from . import properties  # noqa: F401
