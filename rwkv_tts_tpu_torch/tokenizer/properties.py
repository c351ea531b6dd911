"""Property (age / gender / emotion / pitch / speed) → control-token mapping.

The PyTorch port's own copy of ``rwkv_tts_tpu/tokenizer/properties.py``.

Behavioral port of the reference's ``src/properties_util.rs`` (tables at
``:8-63``, conversion at ``:76-98``, numeric classifiers at ``:109-314``).
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


def classify_age(age: int) -> str:
    """Numeric age → class (properties_util.rs:302-314)."""
    if age < 13:
        return "child"
    if age < 20:
        return "teenager"
    if age < 40:
        return "youth-adult"
    if age < 65:
        return "middle-aged"
    return "elderly"


def age_string_to_number(age_str: str) -> int:
    """Age class → representative numeric age (properties_util.rs:284-293)."""
    return {
        "child": 10,
        "teenager": 16,
        "youth-adult": 25,
        "middle-aged": 45,
        "elderly": 70,
    }.get(age_str, 25)


# (low, medium, high) upper bounds per (gender, age-class); a pitch >= the
# last bound is "very_high_pitch" (females "child" has no very_high tier).
_FEMALE_PITCH_BOUNDS = {
    "child": (250.0, 290.0, float("inf")),
    "teenager": (208.0, 238.0, 270.0),
    "youth-adult": (191.0, 211.0, 232.0),
    "middle-aged": (176.0, 195.0, 215.0),
    "elderly": (170.0, 190.0, 213.0),
    None: (187.0, 209.0, 232.0),
}

_MALE_PITCH_BOUNDS = {
    "teenager": (121.0, 143.0, 166.0),
    "youth-adult": (115.0, 131.0, 153.0),
    "middle-aged": (110.0, 125.0, 147.0),
    "elderly": (115.0, 128.0, 142.0),
    None: (114.0, 130.0, 151.0),
}


def classify_pitch(pitch: float, gender: str, age: int) -> str:
    """Numeric pitch (Hz) → class, per gender×age tables
    (properties_util.rs:109-254)."""
    gender = (gender or "").lower()
    age_class = classify_age(age)
    if gender == "female":
        bounds = _FEMALE_PITCH_BOUNDS.get(age_class, _FEMALE_PITCH_BOUNDS[None])
    elif gender == "male":
        bounds = _MALE_PITCH_BOUNDS.get(age_class, _MALE_PITCH_BOUNDS[None])
    else:
        bounds = (130.0, 180.0, 220.0)
    lo, mid, hi = bounds
    if pitch < lo:
        return "low_pitch"
    if pitch < mid:
        return "medium_pitch"
    if pitch < hi:
        return "high_pitch"
    return "very_high_pitch"


def classify_speed(speed: float) -> str:
    """Numeric speed (syllables/s) → class (properties_util.rs:263-275)."""
    if speed <= 3.5:
        return "very_slow"
    if speed < 4.0:
        return "slow"
    if speed <= 4.5:
        return "medium"
    if speed <= 5.0:
        return "fast"
    return "very_fast"


def convert_properties_to_tokens(
    speed: float, pitch: float, age: int, gender: str, emotion: str
) -> List[int]:
    """Numeric properties → token ids (properties_util.rs:327-339)."""
    return convert_standard_properties_to_tokens(
        classify_age(age),
        gender,
        emotion,
        classify_pitch(pitch, gender, age),
        classify_speed(speed),
    )
