"""Copy of ``intelligent_video_analysis_retrieval_system_tpu/retrieval/textproc.py``: the JAX
package's ``retrieval/__init__.py`` imports the JAX temporal module, so the module cannot be
imported where JAX is not installed. Keep the two in step.

Dependency-free query text analysis (the reference's spaCy analog).

The reference runs spaCy ``en_core_web_sm`` in two places: CLIP query
understanding (tokens / noun chunks / entities, ``core.py:1751-1794``)
and translated-query feature extraction for the translation service
(``api.py:2261-2416``). spaCy is a heavyweight host dependency with no
TPU relevance, so this module reimplements the *used* subset with a
rule-based part-of-speech tagger (closed-class wordlists + suffix rules
+ a compact visual-noun/adjective lexicon), POS-driven noun chunking
(``(ADJ|NOUN)* NOUN`` runs, like spaCy's ``noun_chunks``), and typed
entity guesses (PROPN sequences + a small gazetteer for GPE/EVENT/ORG
labels). Deterministic, no model download, safe in sealed environments.

Round 4 upgraded this from flat stopword stripping to the tagger:
previously "man running fast" chunked as one pseudo-noun-phrase; the
POS pass now separates verbs from nouns, recognises ``-ing`` NOUNS
(building, painting, wedding), and types entities.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "TextAnalysis",
    "analyze_text",
    "content_words",
    "expand_variants",
    "pos_tag",
]

_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z'\-]*|\d+")

# -- closed-class wordlists (function words; spaCy POS-tag analog) ----------

_DET = frozenset("""
a an the this that these those my your his her its our their some any
each every no all both few many most much several such another other
""".split())
_ADP = frozenset("""
in on at by with without from of to for over under near behind above
below beside across through during against between among around along
inside outside onto into upon toward towards off up down out about after
before since until within
""".split())
_PRON = frozenset("""
i you he she it we they me him us them who whom which what whose
someone anyone everyone something anything everything
""".split())
_CONJ = frozenset("and or but nor so yet while when where if than because".split())
_AUX = frozenset("""
is are was were be been being am do does did doing have has had having
will would can could shall should may might must
""".split())
_ADV = frozenset("""
very too quite really almost always never often sometimes now then here
there just still also not fast slowly quickly together only own same
more even ever
""".split())
_NUM_WORDS = frozenset("""
one two three four five six seven eight nine ten eleven twelve twenty
thirty forty fifty hundred thousand million first second third
""".split())

# -- open-class lexicons (compact; the visual vocabulary the system sees) ---

# Common nouns, including the -ing/-ed-looking ones the suffix rules
# would otherwise mistag as verbs (building, painting, wedding, bed).
_NOUN_LEX = frozenset("""
man woman person child people children men women boy girl baby guy lady
dog cat bird fish horse cow sheep elephant tiger lion monkey animal
car truck bus motorbike bicycle bike train airplane plane boat ship
helicopter vehicle taxi
street road city town village countryside building house home bridge
tower market school hospital restaurant church temple pagoda stadium
park station airport harbor office shop store mall hotel museum
tree flower grass forest mountain hill river lake sea ocean beach sand
sky cloud rain snow sun moon star sunset sunrise night morning evening
daytime noon fire smoke water ice wind storm rainbow
ball football soccer basketball tennis game match sport race
news anchor reporter interview microphone camera stage concert crowd
festival ceremony parade celebration wedding party flag banner
food fruit vegetable rice noodle bread meat fish cake coffee tea drink
table chair bed sofa door window wall floor ceiling roof room kitchen
shirt dress hat helmet uniform clothing glasses bag backpack umbrella
phone computer laptop screen television book paper sign poster
painting drawing photo picture image frame video clip scene shot
police officer doctor nurse teacher student farmer worker soldier
driver player singer dancer artist chef vendor
group team family couple pair line queue
color light shadow background foreground side top bottom middle center
day year time moment second minute hour week month
lightning thunder dawn dusk field garden farm yard playground
""".split())

# Irregular plurals map to the lexicon via _singularize; these are extra.
_ADJ_LEX = frozenset("""
red orange yellow green blue purple pink brown black white gray grey
golden silver dark bright colorful colourful
big small large little huge tiny tall short long wide narrow
old young new ancient modern
beautiful pretty ugly happy sad angry busy quiet loud crowded empty
fast slow hot cold warm cool wet dry clean dirty
traditional famous important main several many few
vietnamese chinese japanese korean american french german spanish
asian european african
""".split())

_COLORS = frozenset(
    "red orange yellow green blue purple pink brown black white gray grey "
    "golden silver dark bright colorful".split()
)

# Honorifics/roles that mark the following PROPN run as a PERSON.
_HONORIFICS = frozenset(
    "mr mrs ms miss dr sir madam president prime minister king queen "
    "prince princess coach captain general professor".split()
)
# Entity-final words that type the whole span.
_EVENT_FINAL = frozenset(
    "festival cup olympics games championship day parade ceremony "
    "carnival marathon".split()
)
_ORG_FINAL = frozenset(
    "university school college company inc corp ltd club fc united city "
    "team bank ministry department agency council association tv network "
    "airlines".split()
)
# Compact GPE gazetteer (countries + frequently-queried cities; the
# reference got this from spaCy NER — a full model is out of scope, this
# covers the corpus languages' home regions plus world capitals).
_GPE = frozenset("""
vietnam hanoi saigon danang hue china beijing shanghai hongkong japan
tokyo osaka kyoto korea seoul busan thailand bangkok indonesia jakarta
bali singapore malaysia india delhi mumbai russia moscow france paris
germany berlin munich spain madrid barcelona italy rome venice england
london uk usa america washington newyork california texas chicago
boston canada toronto brazil rio mexico egypt cairo australia sydney
melbourne africa europe asia
""".split())

# Suffix rules for open-class words not in the lexicons (ordered).
# Short "-al"/"-ic" words (goal, epic, music) are usually nouns, so those
# two suffixes only fire on longer derivations (traditional, historic).
_ADJ_SUFFIXES = ("ous", "ful", "ish", "ive", "able", "ible", "less",
                 "ian")
_ADJ_SUFFIXES_LONG = ("al", "ic")
_NOUN_SUFFIXES = ("tion", "sion", "ment", "ness", "ity", "ism", "ist",
                  "ance", "ence", "ship", "hood", "scape")

_IRREGULAR_PLURALS = {
    "people": "person", "children": "child", "men": "man",
    "women": "woman", "feet": "foot", "teeth": "tooth", "mice": "mouse",
    "geese": "goose",
}


def _singularize(word: str) -> str:
    """Cheap singular form for lexicon lookups (not a full lemmatizer)."""
    if word in _IRREGULAR_PLURALS:
        return _IRREGULAR_PLURALS[word]
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith("es") and len(word) > 4 and word[-3] in "sxzh":
        return word[:-2]
    if word.endswith("s") and not word.endswith("ss") and len(word) > 3:
        return word[:-1]
    return word


def _tag_one(token: str, lower: str, at_start: bool) -> str:
    """Tag a single token (context-free rules; runs are fixed up later)."""
    if token.isdigit() or lower in _NUM_WORDS:
        return "NUM"
    if lower in _DET:
        return "DET"
    if lower in _ADP:
        return "ADP"
    if lower in _PRON:
        return "PRON"
    if lower in _CONJ:
        return "CONJ"
    if lower in _AUX:
        return "AUX"
    if lower in _ADV:
        return "ADV"
    singular = _singularize(lower)
    in_noun_lex = lower in _NOUN_LEX or singular in _NOUN_LEX
    in_adj_lex = lower in _ADJ_LEX
    # capitalized unknown word => proper noun; at sentence start, suffix
    # evidence wins first ("Running dog" is a verb, "Messi scoring" a name)
    if token[:1].isupper():
        if token.isupper() and len(token) >= 2:
            return "PROPN"  # acronym
        if lower in _GPE:
            return "PROPN"
        if not in_noun_lex and not in_adj_lex \
                and lower not in _STOPWORDS_EXTRA:
            has_suffix_evidence = (
                (lower.endswith("ing") and len(lower) > 5)
                or (lower.endswith("ed") and len(lower) > 4)
                or (lower.endswith("ly") and len(lower) > 4)
                or lower.endswith(_ADJ_SUFFIXES)
                or lower.endswith(_NOUN_SUFFIXES)
            )
            if not (at_start and has_suffix_evidence):
                return "PROPN"
    if in_adj_lex:
        return "ADJ"
    if in_noun_lex:
        return "NOUN"
    if lower.endswith("ly") and len(lower) > 4:
        return "ADV"
    if lower.endswith("ing") and len(lower) > 5:
        return "VERB"
    if lower.endswith("ed") and len(lower) > 4:
        return "VERB"
    if lower.endswith(_ADJ_SUFFIXES):
        return "ADJ"
    if lower.endswith(_ADJ_SUFFIXES_LONG) and len(lower) >= 6:
        return "ADJ"
    if lower.endswith(_NOUN_SUFFIXES):
        return "NOUN"
    # queries are noun-heavy: default open-class to NOUN (spaCy's
    # out-of-vocabulary behavior on short fragments is similar)
    return "NOUN"


# extra words we never want to promote to PROPN at sentence start
_STOPWORDS_EXTRA = frozenset(
    "show find get want looking look search give list display".split()
)


def pos_tag(text: str) -> list[tuple[str, str]]:
    """Rule-based POS tags: DET/ADP/PRON/CONJ/AUX/ADV/NUM/ADJ/NOUN/
    PROPN/VERB (coarse universal-tag subset; reference used spaCy,
    ``core.py:1751-1794``)."""
    tokens = _TOKEN_RE.findall(text)
    return [
        (t, _tag_one(t, t.lower(), i == 0)) for i, t in enumerate(tokens)
    ]


# Stopwords for content-word extraction = all closed classes + query verbs
# that carry no visual signal.
_STOPWORDS = (
    _DET | _ADP | _PRON | _CONJ | _AUX | _ADV | _STOPWORDS_EXTRA
    | frozenset("photo image picture frame video clip scene shot me "
                "there it not it's don't doesn't isn't can't won't i'm "
                "you're we're they're that's what's there's".split())
)


@dataclass(slots=True)
class TextAnalysis:
    """Structured view of a query (reference spaCy doc analog)."""

    text: str
    tokens: list[str] = field(default_factory=list)
    content_words: list[str] = field(default_factory=list)
    noun_phrases: list[str] = field(default_factory=list)
    entities: list[str] = field(default_factory=list)
    colors: list[str] = field(default_factory=list)
    actions: list[str] = field(default_factory=list)
    pos: list[tuple[str, str]] = field(default_factory=list)
    entity_types: list[tuple[str, str]] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "text": self.text,
            "tokens": self.tokens,
            "content_words": self.content_words,
            "noun_phrases": self.noun_phrases,
            "entities": self.entities,
            "colors": self.colors,
            "actions": self.actions,
            "pos": [list(p) for p in self.pos],
            "entity_types": [list(e) for e in self.entity_types],
        }


def _dedup(seq: list[str]) -> list[str]:
    seen: set[str] = set()
    out: list[str] = []
    for s in seq:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def _entity_label(span_tokens: list[str], prev_lower: str) -> str:
    """Type a PROPN span: PERSON (honorific before or leading the span),
    EVENT/ORG (typing final word outranks a gazetteer hit: "Hanoi
    University" is an ORG), then GPE (gazetteer), else MISC."""
    if not span_tokens:
        # a span can be connector-only after filtering ("De" alone tags
        # PROPN, then the of/the/de/da strip empties it) — hypothesis find
        return "MISC"
    lowered = [t.lower() for t in span_tokens]
    if prev_lower in _HONORIFICS or (
        len(lowered) >= 2 and lowered[0] in _HONORIFICS
    ):
        return "PERSON"
    if lowered[-1] in _EVENT_FINAL:
        return "EVENT"
    if lowered[-1] in _ORG_FINAL or (
        span_tokens[-1].isupper() and len(span_tokens[-1]) >= 2
    ):
        return "ORG"
    joined = "".join(lowered)
    if joined in _GPE or any(t in _GPE for t in lowered):
        return "GPE"
    return "MISC"


def analyze_text(text: str) -> TextAnalysis:
    """Tokenize + POS-tag + extract visual features from a (translated)
    query: content words, noun chunks, typed entities, colors, actions."""
    tagged = pos_tag(text)
    tokens = [t for t, _ in tagged]
    lower = [t.lower() for t in tokens]

    content = [
        lw for (tok, tag), lw in zip(tagged, lower)
        if tag not in ("DET", "ADP", "PRON", "CONJ", "AUX", "NUM")
        and lw not in _STOPWORDS and len(lw) > 1
    ]

    # noun chunks: maximal (ADJ|NOUN|PROPN|VERB-participle-modifier)?
    # runs ending in a NOUN/PROPN — spaCy noun_chunks approximation,
    # lowercase, determiners excluded. A participle directly before a
    # noun acts as a modifier ("running water"), otherwise it breaks
    # the chunk ("man running fast" -> ["man"]).
    phrases: list[str] = []
    run: list[tuple[str, str]] = []  # (lower, tag)

    def flush_run() -> None:
        while run and run[-1][1] not in ("NOUN", "PROPN"):
            run.pop()  # trailing modifiers without a head are not chunks
        if len(run) >= 2:
            phrases.append(" ".join(w for w, _ in run))

    for (tok, tag), lw in zip(tagged, lower):
        if tag in ("ADJ", "NOUN", "PROPN") and len(lw) > 1 \
                and lw not in _STOPWORDS:
            run.append((lw, tag))
        elif tag == "VERB" and lw.endswith("ing") and run \
                and run[-1][1] == "ADJ":
            run.append((lw, tag))  # "bright shining star" style
        else:
            flush_run()
            run = []
    flush_run()

    # entities: PROPN runs, allowing internal of/the/de between PROPNs
    # ("Statue of Liberty"); typed via _entity_label
    entities: list[str] = []
    entity_types: list[tuple[str, str]] = []
    i = 0
    while i < len(tagged):
        tok, tag = tagged[i]
        if tag == "PROPN":
            j = i + 1
            span = [tok]
            while j < len(tagged):
                ntok, ntag = tagged[j]
                # absorb capitalized common nouns too: "Tet Festival"
                # ("festival" is in the noun lexicon, but its
                # capitalization marks it as part of the name)
                if ntag == "PROPN" or (
                    ntok[:1].isupper() and ntag in ("NOUN", "ADJ")
                ):
                    span.append(ntok)
                    j += 1
                elif (
                    lower[j] in ("of", "the", "de", "da")
                    and j + 1 < len(tagged)
                    and tagged[j + 1][1] == "PROPN"
                ):
                    span.append(ntok)
                    span.append(tagged[j + 1][0])
                    j += 2
                else:
                    break
            prev_lower = lower[i - 1] if i > 0 else ""
            label = _entity_label(
                [t for t in span if t.lower() not in ("of", "the", "de",
                                                      "da")],
                prev_lower,
            )
            entities.append(" ".join(span))
            entity_types.append((" ".join(span), label))
            i = j
        else:
            i += 1

    colors = [w for w in content if w in _COLORS]
    actions = [
        lw for (tok, tag), lw in zip(tagged, lower)
        if tag == "VERB" and lw.endswith("ing") and len(lw) > 5
    ]
    return TextAnalysis(
        text=text,
        tokens=tokens,
        content_words=_dedup(content),
        noun_phrases=_dedup(phrases),
        entities=_dedup(entities),
        colors=_dedup(colors),
        actions=_dedup(actions),
        pos=tagged,
        entity_types=entity_types,
    )


def content_words(text: str) -> list[str]:
    """Stopword-stripped lowercase keywords (translator/keyword helper)."""
    return analyze_text(text).content_words


def expand_variants(text: str, max_variants: int = 3) -> list[str]:
    """Cheap query expansion without an LLM (``core.py:2901-2913`` shim
    upgrade): the original, the content-word reduction, and the longest
    noun phrase — deduplicated, original first."""
    a = analyze_text(text)
    variants = [text.strip()]
    if a.content_words:
        variants.append(" ".join(a.content_words))
    if a.noun_phrases:
        variants.append(max(a.noun_phrases, key=len))
    return _dedup([v for v in variants if v])[:max_variants]
