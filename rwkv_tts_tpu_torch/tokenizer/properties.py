"""Property (age / gender / emotion / pitch / speed) → control-token mapping.

The PyTorch port's own copy of the tables and the class-name conversion
of ``rwkv_tts_tpu/tokenizer/properties.py``.

Behavioral port of the reference's ``src/properties_util.rs`` (tables at
``:8-63``, conversion at ``:76-98``; the numeric classifiers of the JAX
package's copy serve the server and are not ported yet).
Property tokens are emitted in the fixed order
``[offset, offset+age, offset+gender, offset+emotion, offset+pitch,
offset+speed]`` where ``offset`` = ``<|spct_0|>`` = 77823.
"""

from __future__ import annotations

from typing import List

from ..constants import TTS_SPECIAL_TOKEN_OFFSET

SPEED_MAP = {
    "very_slow": 1,
    "slow": 2,
    "medium": 3,
    "fast": 4,
    "very_fast": 5,
}

PITCH_MAP = {
    "low_pitch": 6,
    "medium_pitch": 7,
    "high_pitch": 8,
    "very_high_pitch": 9,
}

AGE_MAP = {
    "child": 13,
    "teenager": 14,
    "youth-adult": 15,
    "middle-aged": 16,
    "elderly": 17,
}

GENDER_MAP = {
    "female": 46,
    "male": 47,
}

EMOTION_MAP = {
    "UNKNOWN": 21,
    "NEUTRAL": 22,
    "ANGRY": 23,
    "HAPPY": 24,
    "SAD": 25,
    "FEARFUL": 26,
    "DISGUSTED": 27,
    "SURPRISED": 28,
    "SARCASTIC": 29,
    "EXCITED": 30,
    "SLEEPY": 31,
    "CONFUSED": 32,
    "EMPHASIS": 33,
    "LAUGHING": 34,
    "SINGING": 35,
    "WORRIED": 36,
    "WHISPER": 37,
    "ANXIOUS": 38,
    "NO-AGREEMENT": 39,
    "APOLOGETIC": 40,
    "CONCERNED": 41,
    "ENUNCIATED": 42,
    "ASSERTIVE": 43,
    "ENCOURAGING": 44,
    "CONTEMPT": 45,
}


def _lookup(table: dict, key: str, default: int) -> int:
    key_l = key.lower() if key else ""
    for k, v in table.items():
        if k.lower() == key_l:
            return v
    return default


def convert_standard_properties_to_tokens(
    age: str, gender: str, emotion: str, pitch: str, speed: str
) -> List[int]:
    """Property class names → token ids (properties_util.rs:76-98).

    Unknown values fall back to the reference defaults
    (speed=medium 3, pitch=medium 7, age=youth-adult 15, gender=female 46,
    emotion=FEARFUL 26).
    """
    speed_token = _lookup(SPEED_MAP, speed, 3)
    pitch_token = _lookup(PITCH_MAP, pitch, 7)
    age_token = _lookup(AGE_MAP, age, 15)
    gender_token = _lookup(GENDER_MAP, gender, 46)
    emotion_token = _lookup(EMOTION_MAP, emotion, 26)
    off = TTS_SPECIAL_TOKEN_OFFSET
    return [
        off,
        off + age_token,
        off + gender_token,
        off + emotion_token,
        off + pitch_token,
        off + speed_token,
    ]
