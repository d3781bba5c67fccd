"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/translator.py``: the JAX
package's ``retrieval/__init__.py`` imports the JAX temporal module, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Multilingual query -> CLIP-optimized English prompt.

Parity with the reference ``UniversalQueryTranslator`` (``core.py:385-684``):
language detection, translation to a CLIP-friendly English prompt, a cache
keyed on the query, and a dictionary fallback for Vietnamese. Differences:

- the LLM call is *pluggable and optional* (``llm_translate_fn``) and never
  sits on the hot search path by default — the reference paid 5-7 s of
  GPT-4o latency per uncached query (``logs/performance.log:8``);
- language detection is a pure Unicode-range heuristic plus a
  function-word scorer for Latin scripts (the reference used langdetect
  with the same heuristic as fallback, ``core.py:485-516``) so it is
  deterministic and dependency-free;
- offline dictionary fallbacks cover TEN query languages
  (vi/zh/ja/ko/ru/th/fr/es/de/id — ``SUPPORTED_OFFLINE_LANGS``) instead
  of wrapping googletrans (zero-egress design; the reference's
  TranslationService, ``api.py:2261-2416``, required network access).
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = [
    "UniversalQueryTranslator",
    "TranslationResult",
    "SUPPORTED_OFFLINE_LANGS",
]

# Vietnamese detection characters, split by evidence strength: the
# UNIQUE set (horn/bar letters + hook-above/dot-below tone vowels) occurs
# in no other common Latin orthography; the SHARED set (plain acute/
# grave/circumflex vowels) also appears in French/Spanish/Portuguese, so
# it is only weak evidence (round 4 — the old single set mis-detected
# French "école" as Vietnamese).
_VI_UNIQUE = set(
    "ăđơưĂĐƠƯ"
    "ảạắằẳẵặấầẩẫậẻẹềếểễệỉịỏọồốổỗộớờởỡợủụừứửữựỳỷỹỵ"
    "ẢẠẮẰẲẴẶẤẦẨẪẬẺẸỀẾỂỄỆỈỊỎỌỒỐỔỖỘỚỜỞỠỢỦỤỪỨỬỮỰỲỶỸỴ"
)
_VI_SHARED = set(
    "âêôáàãéèẽíìĩóòõúùũý"
    "ÂÊÔÁÀÃÉÈẼÍÌĨÓÒÕÚÙŨÝ"
)

_CJK = (0x4E00, 0x9FFF)
_HIRAGANA = (0x3040, 0x30FF)
_HANGUL = (0xAC00, 0xD7AF)
_CYRILLIC = (0x0400, 0x04FF)
_THAI = (0x0E00, 0x0E7F)
_ARABIC = (0x0600, 0x06FF)


# Compact Vietnamese->English dictionary for the offline fallback
# (same role as reference core.py:657-684, expanded for video-search terms).
_VI_EN: dict[str, str] = {
    "người": "person", "đàn ông": "man", "phụ nữ": "woman", "trẻ em": "child",
    "con chó": "dog", "con mèo": "cat", "con chim": "bird", "con cá": "fish",
    "xe hơi": "car", "ô tô": "car", "xe máy": "motorbike", "xe đạp": "bicycle",
    "xe buýt": "bus", "xe tải": "truck", "tàu": "ship", "thuyền": "boat",
    "máy bay": "airplane", "đường phố": "street", "tòa nhà": "building",
    "ngôi nhà": "house", "cây": "tree", "hoa": "flower", "núi": "mountain",
    "biển": "sea", "bãi biển": "beach", "sông": "river", "hồ": "lake",
    "bầu trời": "sky", "mây": "cloud", "mưa": "rain", "nắng": "sunny",
    "ban đêm": "at night", "ban ngày": "daytime", "buổi sáng": "morning",
    "buổi tối": "evening", "hoàng hôn": "sunset", "bình minh": "sunrise",
    "màu đỏ": "red", "màu xanh": "blue", "màu xanh lá": "green",
    "màu vàng": "yellow", "màu trắng": "white", "màu đen": "black",
    "đang chạy": "running", "đang đi bộ": "walking", "đang nói": "talking",
    "đang ăn": "eating", "đang uống": "drinking", "đang ngồi": "sitting",
    "đang đứng": "standing", "đang nhảy": "jumping", "đang bơi": "swimming",
    "đang lái xe": "driving", "đang chơi": "playing", "đang hát": "singing",
    "đang khóc": "crying", "đang cười": "laughing", "đám đông": "crowd",
    "sân khấu": "stage", "trận đấu": "match", "bóng đá": "football",
    "tin tức": "news", "phát thanh viên": "news anchor", "phỏng vấn": "interview",
    "cảnh sát": "police", "bác sĩ": "doctor", "học sinh": "student",
    "trường học": "school", "bệnh viện": "hospital", "chợ": "market",
    "nhà hàng": "restaurant", "thành phố": "city", "nông thôn": "countryside",
    "cánh đồng": "field", "áo dài": "ao dai traditional dress",
    "nón lá": "conical hat", "cờ": "flag", "lễ hội": "festival",
    "đêm": "night", "và": "and", "với": "with", "trên": "on", "trong": "in",
    "một": "a", "nhiều": "many", "lớn": "big", "nhỏ": "small",
    "đẹp": "beautiful", "cũ": "old", "mới": "new", "nhanh": "fast",
    "chậm": "slow", "cao": "tall", "thấp": "short",
}

# Compact zh/ja visual-term dictionaries: same offline-fallback role as
# the Vietnamese one (the reference only shipped vi, core.py:657-684;
# detection already distinguishes zh/ja by unicode range, so a small
# dictionary turns those queries from 0.2-confidence passthrough into
# usable CLIP prompts). Entries are common video-search nouns/scenes.
_ZH_EN: dict[str, str] = {
    "人": "person", "男人": "man", "女人": "woman", "孩子": "child",
    "狗": "dog", "猫": "cat", "鸟": "bird", "鱼": "fish", "马": "horse",
    "汽车": "car", "摩托车": "motorbike", "自行车": "bicycle",
    "公共汽车": "bus", "卡车": "truck", "船": "boat", "飞机": "airplane",
    "火车": "train", "街道": "street", "城市": "city", "乡村": "countryside",
    "海滩": "beach", "大海": "sea", "山": "mountain", "河": "river",
    "树": "tree", "花": "flower", "天空": "sky", "云": "cloud",
    "雨": "rain", "雪": "snow", "夜晚": "night", "日落": "sunset",
    "建筑": "building", "桥": "bridge", "市场": "market", "学校": "school",
    "医院": "hospital", "餐厅": "restaurant", "警察": "police",
    "医生": "doctor", "足球": "football", "跑步": "running",
    "游泳": "swimming", "跳舞": "dancing", "唱歌": "singing",
    "吃饭": "eating", "红色": "red", "蓝色": "blue", "绿色": "green",
    "黄色": "yellow", "黑色": "black", "白色": "white", "大": "big",
    "小": "small", "新闻": "news", "采访": "interview", "节日": "festival",
    "国旗": "flag", "和": "and", "在": "in", "的": " ",
}
_JA_EN: dict[str, str] = {
    "人": "person", "男の人": "man", "女の人": "woman", "子供": "child",
    "犬": "dog", "猫": "cat", "鳥": "bird", "魚": "fish", "馬": "horse",
    "車": "car", "バイク": "motorbike", "自転車": "bicycle",
    "バス": "bus", "トラック": "truck", "船": "boat", "飛行機": "airplane",
    "電車": "train", "通り": "street", "都市": "city", "田舎": "countryside",
    "ビーチ": "beach", "海": "sea", "山": "mountain", "川": "river",
    "木": "tree", "花": "flower", "空": "sky", "雲": "cloud",
    "雨": "rain", "雪": "snow", "夜": "night", "夕日": "sunset",
    "建物": "building", "橋": "bridge", "市場": "market", "学校": "school",
    "病院": "hospital", "レストラン": "restaurant", "警察": "police",
    "医者": "doctor", "サッカー": "football", "走っている": "running",
    "泳いでいる": "swimming", "踊っている": "dancing", "歌っている": "singing",
    "食べている": "eating", "赤い": "red", "青い": "blue", "緑の": "green",
    "黄色い": "yellow", "黒い": "black", "白い": "white", "大きい": "big",
    "小さい": "small", "ニュース": "news", "祭り": "festival",
    "旗": "flag", "と": "and", "の": " ", "で": "in",
}

# Round-4 breadth expansion (reference TranslationService wraps
# googletrans and accepts ANY language, api.py:2261-2416; this offline
# rebuild instead ships compact visual-vocabulary dictionaries for the
# ten most common query languages). Non-Latin scripts are detected by
# unicode range; Latin-script languages by stopword/diacritic scoring
# (_detect_latin below).
_KO_EN: dict[str, str] = {
    "사람": "person", "남자": "man", "여자": "woman", "아이": "child",
    "강아지": "dog", "개": "dog", "고양이": "cat", "새": "bird", "말": "horse",
    "자동차": "car", "오토바이": "motorbike", "자전거": "bicycle",
    "버스": "bus", "트럭": "truck", "기차": "train", "비행기": "airplane",
    "보트": "boat", "거리": "street", "도시": "city", "시골": "countryside",
    "해변": "beach", "바다": "sea", "산": "mountain", "강": "river",
    "나무": "tree", "꽃": "flower", "하늘": "sky", "구름": "cloud",
    "비": "rain", "눈": "snow", "밤": "night", "일몰": "sunset",
    "건물": "building", "다리": "bridge", "시장": "market", "학교": "school",
    "병원": "hospital", "식당": "restaurant", "경찰": "police",
    "의사": "doctor", "축구": "football", "달리는": "running",
    "수영": "swimming", "춤추는": "dancing", "노래하는": "singing",
    "먹는": "eating", "빨간": "red", "파란": "blue", "초록": "green",
    "노란": "yellow", "검은": "black", "흰": "white", "군중": "crowd",
    "뉴스": "news", "인터뷰": "interview", "축제": "festival",
    "깃발": "flag",
}
_RU_EN: dict[str, str] = {
    "человек": "person", "мужчина": "man", "женщина": "woman",
    "ребенок": "child", "ребёнок": "child", "собака": "dog",
    "кошка": "cat", "птица": "bird", "лошадь": "horse",
    "машина": "car", "автомобиль": "car", "мотоцикл": "motorbike",
    "велосипед": "bicycle", "автобус": "bus", "грузовик": "truck",
    "поезд": "train", "самолет": "airplane", "самолёт": "airplane",
    "лодка": "boat", "улица": "street", "город": "city",
    "деревня": "countryside", "пляж": "beach", "море": "sea",
    "гора": "mountain", "река": "river", "дерево": "tree",
    "цветок": "flower", "небо": "sky", "облако": "cloud",
    "дождь": "rain", "снег": "snow", "ночь": "night", "ночью": "at night",
    "закат": "sunset", "здание": "building", "дом": "house",
    "мост": "bridge", "рынок": "market", "школа": "school",
    "больница": "hospital", "ресторан": "restaurant",
    "полиция": "police", "врач": "doctor", "футбол": "football",
    "бежит": "running", "бегущий": "running", "идет": "walking",
    "плавает": "swimming", "танцует": "dancing", "поет": "singing",
    "ест": "eating", "красный": "red", "красная": "red",
    "синий": "blue", "синяя": "blue", "зеленый": "green",
    "зелёный": "green", "желтый": "yellow", "жёлтый": "yellow",
    "белый": "white", "белая": "white", "черный": "black",
    "чёрный": "black", "толпа": "crowd", "новости": "news",
    "интервью": "interview", "праздник": "festival", "флаг": "flag",
    "и": "and", "на": "on", "в": "in", "с": "with",
}
_TH_EN: dict[str, str] = {
    "คน": "person", "ผู้ชาย": "man", "ผู้หญิง": "woman", "เด็ก": "child",
    "สุนัข": "dog", "หมา": "dog", "แมว": "cat", "นก": "bird", "ม้า": "horse",
    "รถยนต์": "car", "มอเตอร์ไซค์": "motorbike", "จักรยาน": "bicycle",
    "รถบัส": "bus", "รถบรรทุก": "truck", "รถไฟ": "train",
    "เครื่องบิน": "airplane", "เรือ": "boat", "ถนน": "street",
    "เมือง": "city", "ชนบท": "countryside", "ชายหาด": "beach",
    "ทะเล": "sea", "ภูเขา": "mountain", "แม่น้ำ": "river",
    "ต้นไม้": "tree", "ดอกไม้": "flower", "ท้องฟ้า": "sky", "เมฆ": "cloud",
    "ฝน": "rain", "หิมะ": "snow", "กลางคืน": "night",
    "พระอาทิตย์ตก": "sunset", "อาคาร": "building", "บ้าน": "house",
    "สะพาน": "bridge", "ตลาด": "market", "โรงเรียน": "school",
    "โรงพยาบาล": "hospital", "ร้านอาหาร": "restaurant",
    "ตำรวจ": "police", "หมอ": "doctor", "ฟุตบอล": "football",
    "วิ่ง": "running", "เดิน": "walking", "ว่ายน้ำ": "swimming",
    "เต้น": "dancing", "ร้องเพลง": "singing", "กิน": "eating",
    "สีแดง": "red", "สีน้ำเงิน": "blue", "สีเขียว": "green",
    "สีเหลือง": "yellow", "สีขาว": "white", "สีดำ": "black",
    "ฝูงชน": "crowd", "ข่าว": "news", "สัมภาษณ์": "interview",
    "เทศกาล": "festival", "ธง": "flag", "รถ": "car",
}
_FR_EN: dict[str, str] = {
    "personne": "person", "homme": "man", "femme": "woman",
    "enfant": "child", "chien": "dog", "chat": "cat", "oiseau": "bird",
    "cheval": "horse", "voiture": "car", "moto": "motorbike",
    "vélo": "bicycle", "bus": "bus", "camion": "truck", "train": "train",
    "avion": "airplane", "bateau": "boat", "rue": "street",
    "ville": "city", "campagne": "countryside", "plage": "beach",
    "mer": "sea", "montagne": "mountain", "rivière": "river",
    "arbre": "tree", "fleur": "flower", "ciel": "sky", "nuage": "cloud",
    "pluie": "rain", "neige": "snow", "nuit": "night",
    "coucher de soleil": "sunset", "bâtiment": "building",
    "maison": "house", "pont": "bridge", "marché": "market",
    "école": "school", "hôpital": "hospital", "restaurant": "restaurant",
    "police": "police", "médecin": "doctor", "football": "football",
    "qui court": "running", "courant": "running", "marchant": "walking",
    "nageant": "swimming", "dansant": "dancing", "chantant": "singing",
    "mangeant": "eating", "rouge": "red", "bleu": "blue", "bleue": "blue",
    "vert": "green", "verte": "green", "jaune": "yellow",
    "blanc": "white", "blanche": "white", "noir": "black",
    "noire": "black", "foule": "crowd", "nouvelles": "news",
    "entretien": "interview", "fête": "festival", "drapeau": "flag",
    "le": "", "la": "", "les": "", "des": "", "du": "", "un": "a",
    "une": "a", "et": "and", "sur": "on", "dans": "in", "avec": "with",
}
_ES_EN: dict[str, str] = {
    "persona": "person", "hombre": "man", "mujer": "woman",
    "niño": "child", "niña": "child", "perro": "dog", "gato": "cat",
    "pájaro": "bird", "caballo": "horse", "coche": "car", "carro": "car",
    "moto": "motorbike", "bicicleta": "bicycle", "autobús": "bus",
    "camión": "truck", "tren": "train", "avión": "airplane",
    "barco": "boat", "calle": "street", "ciudad": "city",
    "campo": "countryside", "playa": "beach", "mar": "sea",
    "montaña": "mountain", "río": "river", "árbol": "tree",
    "flor": "flower", "cielo": "sky", "nube": "cloud", "lluvia": "rain",
    "nieve": "snow", "noche": "night", "atardecer": "sunset",
    "edificio": "building", "casa": "house", "puente": "bridge",
    "mercado": "market", "escuela": "school", "hospital": "hospital",
    "restaurante": "restaurant", "policía": "police", "médico": "doctor",
    "fútbol": "football", "corriendo": "running", "caminando": "walking",
    "nadando": "swimming", "bailando": "dancing", "cantando": "singing",
    "comiendo": "eating", "rojo": "red", "roja": "red", "azul": "blue",
    "verde": "green", "amarillo": "yellow", "blanco": "white",
    "blanca": "white", "negro": "black", "negra": "black",
    "multitud": "crowd", "noticias": "news", "entrevista": "interview",
    "fiesta": "festival", "bandera": "flag", "el": "", "la": "",
    "los": "", "las": "", "un": "a", "una": "a", "y": "and", "en": "in",
    "con": "with", "sobre": "on",
}
_DE_EN: dict[str, str] = {
    "person": "person", "mann": "man", "frau": "woman", "kind": "child",
    "hund": "dog", "katze": "cat", "vogel": "bird", "pferd": "horse",
    "auto": "car", "motorrad": "motorbike", "fahrrad": "bicycle",
    "bus": "bus", "lastwagen": "truck", "zug": "train",
    "flugzeug": "airplane", "boot": "boat", "straße": "street",
    "strasse": "street", "stadt": "city", "land": "countryside",
    "strand": "beach", "meer": "sea", "berg": "mountain",
    "fluss": "river", "baum": "tree", "blume": "flower",
    "himmel": "sky", "wolke": "cloud", "regen": "rain", "schnee": "snow",
    "nacht": "night", "sonnenuntergang": "sunset",
    "gebäude": "building", "haus": "house", "brücke": "bridge",
    "markt": "market", "schule": "school", "krankenhaus": "hospital",
    "restaurant": "restaurant", "polizei": "police", "arzt": "doctor",
    "fußball": "football", "läuft": "running", "laufend": "running",
    "rennt": "running", "geht": "walking", "schwimmt": "swimming",
    "tanzt": "dancing", "singt": "singing", "isst": "eating",
    "rot": "red", "rotes": "red", "roter": "red", "blau": "blue",
    "blaues": "blue", "grün": "green", "grünes": "green",
    "gelb": "yellow", "weiß": "white", "weisses": "white",
    "schwarz": "black", "menge": "crowd", "nachrichten": "news",
    "interview": "interview", "fest": "festival", "flagge": "flag",
    "der": "", "die": "", "das": "", "ein": "a", "eine": "a",
    "und": "and", "auf": "on", "mit": "with", "im": "in", "in": "in",
}
_ID_EN: dict[str, str] = {
    "orang": "person", "pria": "man", "laki-laki": "man",
    "wanita": "woman", "anak": "child", "anjing": "dog",
    "kucing": "cat", "burung": "bird", "kuda": "horse", "mobil": "car",
    "sepeda motor": "motorbike", "sepeda": "bicycle", "bus": "bus",
    "truk": "truck", "kereta": "train", "pesawat": "airplane",
    "kapal": "boat", "perahu": "boat", "jalan": "street",
    "kota": "city", "desa": "countryside", "pantai": "beach",
    "laut": "sea", "gunung": "mountain", "sungai": "river",
    "pohon": "tree", "bunga": "flower", "langit": "sky", "awan": "cloud",
    "hujan": "rain", "salju": "snow", "malam": "night",
    "matahari terbenam": "sunset", "gedung": "building",
    "rumah sakit": "hospital", "rumah": "house", "jembatan": "bridge",
    "pasar": "market", "sekolah": "school", "restoran": "restaurant",
    "polisi": "police", "dokter": "doctor", "sepak bola": "football",
    "berlari": "running", "berjalan": "walking", "berenang": "swimming",
    "menari": "dancing", "bernyanyi": "singing", "makan": "eating",
    "merah": "red", "biru": "blue", "hijau": "green",
    "kuning": "yellow", "putih": "white", "hitam": "black",
    "kerumunan": "crowd", "berita": "news", "wawancara": "interview",
    "festival": "festival", "bendera": "flag", "dan": "and",
    "di": "in", "dengan": "with", "yang": "", "sedang": "",
}

# Longest-phrase-first matching order, per language.
_VI_EN_ORDERED = sorted(_VI_EN.items(), key=lambda kv: -len(kv[0]))
_DICTS_ORDERED: dict[str, list[tuple[str, str]]] = {
    "vi": _VI_EN_ORDERED,
    "zh": sorted(_ZH_EN.items(), key=lambda kv: -len(kv[0])),
    "ja": sorted(_JA_EN.items(), key=lambda kv: -len(kv[0])),
    "ko": sorted(_KO_EN.items(), key=lambda kv: -len(kv[0])),
    "ru": sorted(_RU_EN.items(), key=lambda kv: -len(kv[0])),
    "th": sorted(_TH_EN.items(), key=lambda kv: -len(kv[0])),
    "fr": sorted(_FR_EN.items(), key=lambda kv: -len(kv[0])),
    "es": sorted(_ES_EN.items(), key=lambda kv: -len(kv[0])),
    "de": sorted(_DE_EN.items(), key=lambda kv: -len(kv[0])),
    "id": sorted(_ID_EN.items(), key=lambda kv: -len(kv[0])),
}
SUPPORTED_OFFLINE_LANGS = tuple(sorted(_DICTS_ORDERED))

# Languages whose dictionaries must match on WORD boundaries (space- or
# inflection-separated scripts where substring matching would fire inside
# unrelated words, e.g. fr "le" inside "fleur"). CJK/Thai/Vietnamese use
# substring matching: no spaces (zh/ja/th), agglutinating particles (ko
# noun+이/을 still contains the noun), or multi-word diacritic phrases (vi).
_WORD_BOUNDARY_LANGS = frozenset({"ru", "fr", "es", "de", "id"})

# Latin-script language detection: function-word sets + diacritic hints
# (the reference delegated this to langdetect inside googletrans; this is
# the same trigram-free shortcut specialised to short search queries).
_LATIN_STOPWORDS: dict[str, frozenset[str]] = {
    "en": frozenset("the a an of in on at is are and with man woman "
                    "person people".split()),
    "fr": frozenset("le la les des un une du de est et qui dans sur avec "
                    "pour ce cette au aux".split()),
    "es": frozenset("el la lo los las un una unas es y que en con por "
                    "para de del al está sobre".split()),
    "de": frozenset("der die das ein eine und ist mit auf für von dem "
                    "den im einem einer".split()),
    "id": frozenset("yang dan di dengan ini itu ada dari ke pada untuk "
                    "sedang adalah".split()),
}
_LATIN_DIACRITICS: dict[str, set[str]] = {
    "fr": set("àâçéèêëîïôùûœ"),
    "es": set("ñ¿¡"),
    "de": set("äöüß"),
}
# Vietnamese function words without unique diacritics ("con mèo" carries
# only the shared grave accent); scored for vi ONLY when at least one
# Vietnamese-style diacritic is present, so Spanish "con" alone never
# reads as Vietnamese.
_VI_LATIN_STOPWORDS = frozenset(
    "con và là của cái một đang trên xin chào anh em có không".split()
)


@dataclass(slots=True)
class TranslationResult:
    """Outcome of query translation (reference CLIPQueryStructure analog,
    ``core.py:175-199``)."""

    original: str
    clip_prompt: str
    detected_language: str
    confidence: float
    method: str  # passthrough | dictionary | llm
    keywords: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "original": self.original,
            "clip_prompt": self.clip_prompt,
            "detected_language": self.detected_language,
            "confidence": self.confidence,
            "method": self.method,
            "keywords": self.keywords,
        }


class UniversalQueryTranslator:
    """Language detection + translation with cache and graceful fallback."""

    def __init__(
        self,
        llm_translate_fn: Callable[[str], str | None] | None = None,
        cache: Any | None = None,
        min_confidence: float = 0.3,  # reference threshold (system.py:778)
    ) -> None:
        self.llm_translate_fn = llm_translate_fn
        self.cache = cache
        self.min_confidence = min_confidence
        self._local_cache: dict[str, TranslationResult] = {}
        self._lock = threading.Lock()

    # -- language detection (reference core.py:485-516 heuristics) ----------

    @staticmethod
    def detect_language(text: str) -> tuple[str, float]:
        """Return (language code, confidence in [0,1]).

        Non-Latin scripts by unicode range; Vietnamese by its unique
        diacritics; remaining Latin text by function-word + diacritic
        scoring across en/fr/es/de/id (``_detect_latin``). The reference
        delegated this to langdetect (``core.py:485-516``); this is the
        deterministic, dependency-free equivalent tuned for short
        search queries.
        """
        if not text.strip():
            return "en", 0.0
        counts = {"vi": 0, "zh": 0, "ja": 0, "ko": 0, "ru": 0, "th": 0, "ar": 0}
        letters = 0
        for ch in text:
            if ch.isalpha():
                letters += 1
            if ch in _VI_UNIQUE:
                counts["vi"] += 1
            cp = ord(ch)
            if _CJK[0] <= cp <= _CJK[1]:
                counts["zh"] += 1
            elif _HIRAGANA[0] <= cp <= _HIRAGANA[1]:
                counts["ja"] += 1
            elif _HANGUL[0] <= cp <= _HANGUL[1]:
                counts["ko"] += 1
            elif _CYRILLIC[0] <= cp <= _CYRILLIC[1]:
                counts["ru"] += 1
            elif _THAI[0] <= cp <= _THAI[1]:
                counts["th"] += 1
            elif _ARABIC[0] <= cp <= _ARABIC[1]:
                counts["ar"] += 1
        if letters == 0:
            return "en", 0.1
        lang, hits = max(counts.items(), key=lambda kv: kv[1])
        if hits == 0:
            return UniversalQueryTranslator._detect_latin(text, letters)
        return lang, min(1.0, 0.4 + hits / letters)

    @staticmethod
    def _detect_latin(text: str, letters: int) -> tuple[str, float]:
        """Score pure-Latin text across en/fr/es/de/id/vi: function-word
        hits weigh 2, language-specific diacritics 1.5, shared
        Vietnamese-style acute/grave/circumflex vowels 1 toward vi."""
        lowered = text.lower()
        words = re.findall(r"[^\W\d_]+", lowered)
        scores: dict[str, float] = {
            lang: 2.0 * sum(w in sw for w in words)
            for lang, sw in _LATIN_STOPWORDS.items()
        }
        for lang, chars in _LATIN_DIACRITICS.items():
            scores[lang] += 1.5 * sum(ch in chars for ch in lowered)
        vi_shared = sum(ch in _VI_SHARED for ch in text)
        scores["vi"] = (
            vi_shared + 2.0 * sum(w in _VI_LATIN_STOPWORDS for w in words)
            if vi_shared > 0 else 0.0
        )
        lang, best = max(scores.items(), key=lambda kv: (kv[1], kv[0] == "en"))
        if best == 0 or (lang != "en" and best <= scores["en"]):
            return "en", 0.9
        if lang == "en":
            return "en", 0.9
        return lang, min(0.9, 0.45 + best / (2.0 * max(1, len(words))))

    # -- translation ---------------------------------------------------------

    def translate_query(self, query: str) -> TranslationResult:
        """Translate ``query`` to a CLIP-friendly English prompt.

        Resolution order: cache -> English passthrough -> optional LLM ->
        dictionary fallback (Vietnamese) -> passthrough with low confidence.
        Never raises (reference guarantee, ``core.py:518-576``).
        """
        query = query.strip()
        with self._lock:
            cached = self._local_cache.get(query)
        if cached is not None:
            return cached
        if self.cache is not None:
            hit = self.cache.get(f"translate::{query}")
            if isinstance(hit, dict) and "clip_prompt" in hit:
                result = TranslationResult(**hit)
                with self._lock:
                    self._local_cache[query] = result
                return result

        lang, lang_conf = self.detect_language(query)
        if lang == "en":
            result = TranslationResult(
                original=query,
                clip_prompt=self._clipify(query),
                detected_language="en",
                confidence=max(lang_conf, 0.9),
                method="passthrough",
                keywords=self._keywords(query),
            )
        else:
            result = self._translate_non_english(query, lang, lang_conf)

        with self._lock:
            self._local_cache[query] = result
        if self.cache is not None:
            try:
                self.cache.set(f"translate::{query}", result.to_dict())
            except Exception:
                pass
        return result

    def _translate_non_english(
        self, query: str, lang: str, lang_conf: float
    ) -> TranslationResult:
        if self.llm_translate_fn is not None:
            try:
                translated = self.llm_translate_fn(query)
            except Exception:
                translated = None
            if translated:
                return TranslationResult(
                    original=query,
                    clip_prompt=self._clipify(translated),
                    detected_language=lang,
                    confidence=0.9,
                    method="llm",
                    keywords=self._keywords(translated),
                )
        if lang in _DICTS_ORDERED:
            translated, coverage = self._dictionary_translate(query, lang)
            if coverage > 0:
                return TranslationResult(
                    original=query,
                    clip_prompt=self._clipify(translated),
                    detected_language=lang,
                    confidence=min(0.85, 0.3 + 0.6 * coverage),
                    method="dictionary",
                    keywords=self._keywords(translated),
                )
        # last resort: raw query, low confidence — caller decides whether
        # to use it (reference uses the prompt only above min_confidence).
        return TranslationResult(
            original=query,
            clip_prompt=query,
            detected_language=lang,
            confidence=0.2,
            method="passthrough",
            keywords=self._keywords(query),
        )

    @staticmethod
    def _dictionary_translate(query: str, lang: str = "vi") -> tuple[str, float]:
        """Longest-phrase-first substitution; returns (text, hit coverage).

        Word-boundary matching for space-separated orthographies (ru/fr/
        es/de/id — substring matching would fire inside unrelated words,
        e.g. fr ``le`` inside ``fleur``); plain substring matching for
        zh/ja/th (no spaces), ko (particles attach to the noun) and vi
        (multi-word phrases)."""
        text = query.lower()
        matched_chars = 0
        boundary = lang in _WORD_BOUNDARY_LANGS
        for src, en in _DICTS_ORDERED[lang]:
            if boundary:
                pat = re.compile(rf"(?<!\w){re.escape(src)}(?!\w)")
                n = len(pat.findall(text))
                if n:
                    matched_chars += len(src) * n
                    text = pat.sub(f" {en} ", text)
            elif src in text:
                matched_chars += len(src) * text.count(src)
                text = text.replace(src, f" {en} ")
        text = re.sub(r"\s+", " ", text).strip()
        coverage = min(1.0, matched_chars / max(1, len(query)))
        return text, coverage

    @staticmethod
    def _clipify(text: str) -> str:
        """Shape text into a CLIP-style caption: 'a photo of ...' prefix when
        the query is a bare noun phrase (mirrors the prompt template intent
        of reference core.py:582-625 without the LLM)."""
        t = re.sub(r"\s+", " ", text).strip().rstrip(".")
        if not t:
            return t
        lowered = t.lower()
        if lowered.startswith(("a photo", "an image", "a picture", "a video",
                               "a frame", "a screenshot")):
            return t
        return f"a photo of {t}"

    @staticmethod
    def _keywords(text: str) -> list[str]:
        # full analyzer lives in retrieval.textproc (the reference's spaCy
        # feature extraction analog, api.py:2261-2416)
        from .textproc import content_words

        return content_words(text)[:10]
