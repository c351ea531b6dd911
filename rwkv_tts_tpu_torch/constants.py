"""Token-space constants for the RWKV-TTS unified vocabulary.

The PyTorch port's own copy of ``rwkv_tts_tpu/constants.py`` (the port
imports nothing of the JAX package); the two must stay equal, which
``tests/test_torch_isolation.py`` checks.

The unified vocab (77,923 ids incl. the reserved id 0) packs semantic audio
tokens, control tags, global (speaker) tokens, text tokens and property-control
tokens into one id space. Layout measured from the reference's
``assets/model/tokenizer.json`` and mirrored by the constants in the reference
Rust implementation (``src/rwkv_sampler.rs:294-299``,
``src/properties_util.rs:5``).

Layout:
  - ``0``                     reserved / padding (absent from tokenizer.json)
  - ``1..8191``               ``<|semantic_token_N|>`` audio codec tokens
  - ``8192``                  ``<|semantic_token_eos|>`` end of semantic stream
  - ``8193..8195``            ``<|tag_0|>``, ``<|tag_1|>``, ``<|tag_2|>``
  - ``8196..12291``           ``<|global_token_0..4095|>`` speaker tokens
  - ``12292``                 ``<|rwkv_tokenizer_end_of_text|>``
  - ``12293..77822``          text tokens (RWKV world vocab, byte-trie)
  - ``77823..77922``          ``<|spct_0..99|>`` property-control tokens
"""

# --- semantic (audio codec) domain --------------------------------------
SEMANTIC_VOCAB = 8192          # semantic token ids live in [0, 8192) … id 0 unused
TTS_EOS_TOKEN = 8192           # <|semantic_token_eos|>

# --- control tags ---------------------------------------------------------
TTS_TAG_0 = 8193               # end-of-text / start-of-global marker
TTS_TAG_1 = 8194               # start-of-semantic marker
TTS_TAG_2 = 8195               # start-of-prompt marker

# --- global (speaker) token domain ---------------------------------------
GLOBAL_TOKEN_OFFSET = 8196     # global token t is fed to the LM as t + 8196
GLOBAL_VOCAB = 4096            # raw global tokens live in [0, 4096)
NUM_GLOBAL_TOKENS = 32         # exactly 32 global tokens are generated/stored

# --- text domain ----------------------------------------------------------
END_OF_TEXT_TOKEN = 12292      # <|rwkv_tokenizer_end_of_text|>
TEXT_TOKEN_START = 12293       # first byte-level text token

# --- property-control (spct) domain --------------------------------------
TTS_SPECIAL_TOKEN_OFFSET = 77823   # <|spct_0|>; properties_util.rs:5
NUM_SPCT_TOKENS = 100

# --- vocabulary sizes -----------------------------------------------------
VOCAB_SIZE = 77923             # ids 0..77922
# Logits/embedding rows padded up to a multiple of 128 (the parameter
# layout both packages share). Ids >= VOCAB_SIZE are never sampled: the
# sampling domains are prefixes of the vocab.
PADDED_VOCAB_SIZE = 78080      # 610 * 128

# --- decode caps (reference: normal_mode_inference.rs:220,316) ------------
MAX_SEMANTIC_TOKENS = 2048
GLOBAL_TOKENS_SIZE = 32

# --- sampling presets (reference: normal_mode_inference.rs:113-133) -------
GLOBAL_SAMPLING = dict(temperature=1.0, top_p=0.95, top_k=20)
SEMANTIC_SAMPLING = dict(temperature=1.0, top_p=0.95, top_k=80)

# Seed offsets for stage-specific RNG streams
# (reference: rwkv_sampler.rs LayeredRandomnessConfig::default, :265-275)
GLOBAL_SEED_OFFSET = 1000
SEMANTIC_SEED_OFFSET = 2000

# --- zero-shot EOS gating (reference: zero_shot_inference.rs:127-149,219) --
ZS_EOS_WINDOW = 12
ZS_EOS_RATIO_THRESHOLD = 0.7
ZS_HARD_MIN_FACTOR = 1.8       # hard min semantic len ≈ 1.8 × |text tokens|
ZS_MIN_LEN_LO = 8
ZS_MIN_LEN_HI = 64
ZS_UPPER_FRAC = 0.9            # hard min capped at 0.9 × semantic limit

# --- audio framing ---------------------------------------------------------
SAMPLE_RATE = 16000
LATENT_HOP_LENGTH = 320        # samples of audio per semantic token
TOKENS_PER_SECOND = SAMPLE_RATE / LATENT_HOP_LENGTH   # 50 semantic tokens/s
REF_SEGMENT_DURATION = 6.0     # seconds of reference audio for the mel branch
