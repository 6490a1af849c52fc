"""Linguistic feature extraction — port of ``keystone_tpu/ops/corenlp.py``
(the reference's ``nodes/nlp/CoreNLPFeatureExtractor.scala``, which wraps
the external sista/CoreNLP ``FastNLPProcessor`` for sentence-split → POS →
lemmatize → NER → n-grams). Host code, copied; only the base class
changes.

The external JVM dependency has no Python counterpart here, so the same
pipeline is made of self-contained host stages that mirror the
reference's observable behavior (CoreNLPFeatureExtractor.scala:21-45):

- sentence splitting with abbreviation guards (the reference's n-grams
  respect sentence boundaries),
- a WordNet-morphy-style lemmatizer: irregular-form exception tables,
  ordered suffix-detachment rules with orthographic repair (consonant
  undoubling, e-restoration), candidates validated against a built-in
  common-lemma lexicon — the same rules+exceptions+lexicon architecture
  as morphy, with a compact embedded lexicon instead of WordNet,
- gazetteer + cue NER over PERSON / LOCATION / ORGANIZATION / DATE /
  NUMBER: each entity token is replaced by its TYPE string, like the
  reference's ``s.entities.get(i) != "O"`` branch; deliberately
  precision-biased (only recognized entities are replaced, like the
  reference's NER — unrecognized capitalized tokens stay discriminative),
- non-entity tokens are lemmatized then normalized exactly like the
  reference's ``normalize`` (strip ``[^a-zA-Z0-9\\s+]``, lowercase),
- per-sentence n-grams joined with spaces, flattened across orders.
"""

from __future__ import annotations

import dataclasses
import re

from keystone_tpu_torch.core.pipeline import Transformer

# ---------------------------------------------------------------------------
# Lemmatizer: exceptions + detachment rules + lexicon (morphy architecture)
# ---------------------------------------------------------------------------

_IRREGULAR = {
    # be / auxiliaries
    "am": "be", "is": "be", "are": "be", "was": "be", "were": "be",
    "been": "be", "being": "be",
    # common irregular verbs (past / participle → lemma)
    "went": "go", "gone": "go", "did": "do", "done": "do", "had": "have",
    "has": "have", "said": "say", "made": "make", "took": "take",
    "taken": "take", "came": "come", "saw": "see", "seen": "see",
    "got": "get", "gotten": "get", "gave": "give", "given": "give",
    "found": "find", "thought": "think", "told": "tell", "knew": "know",
    "known": "know", "became": "become", "left": "leave", "felt": "feel",
    "brought": "bring", "began": "begin", "begun": "begin", "kept": "keep",
    "held": "hold", "wrote": "write", "written": "write", "stood": "stand",
    "heard": "hear", "meant": "mean", "met": "meet", "ran": "run",
    "paid": "pay", "sat": "sit", "spoke": "speak", "spoken": "speak",
    "led": "lead", "grew": "grow", "grown": "grow", "lost": "lose",
    "fell": "fall", "fallen": "fall", "sent": "send", "built": "build",
    "understood": "understand", "drew": "draw", "drawn": "draw",
    "broke": "break", "broken": "break", "spent": "spend", "rose": "rise",
    "risen": "rise", "drove": "drive", "driven": "drive", "bought": "buy",
    "wore": "wear", "worn": "wear", "chose": "choose", "chosen": "choose",
    "ate": "eat", "eaten": "eat", "flew": "fly", "flown": "fly",
    "caught": "catch", "taught": "teach", "fought": "fight",
    "sought": "seek", "slept": "sleep", "won": "win", "sold": "sell",
    "threw": "throw", "thrown": "throw", "shot": "shoot", "swam": "swim",
    "swum": "swim", "sang": "sing", "sung": "sing", "rang": "ring",
    "rung": "ring", "drank": "drink", "drunk": "drink", "spread": "spread",
    "struck": "strike", "hung": "hang", "dealt": "deal", "bent": "bend",
    "lent": "lend", "laid": "lay", "bore": "bear",
    "borne": "bear", "beat": "beat", "beaten": "beat", "bit": "bite",
    "bitten": "bite", "blew": "blow", "blown": "blow", "forgot": "forget",
    "forgotten": "forget", "froze": "freeze", "frozen": "freeze",
    "hid": "hide", "hidden": "hide", "lit": "light", "rode": "ride",
    "ridden": "ride", "shook": "shake", "shaken": "shake", "stole": "steal",
    "stolen": "steal", "tore": "tear", "torn": "tear", "woke": "wake",
    "woken": "wake", "wound": "wind", "spun": "spin", "dug": "dig",
    "stuck": "stick", "swore": "swear", "sworn": "swear",
    # irregular plurals
    "children": "child", "men": "man", "women": "woman",
    "people": "person", "feet": "foot", "teeth": "tooth", "mice": "mouse",
    "geese": "goose", "oxen": "ox", "criteria": "criterion",
    "phenomena": "phenomenon", "analyses": "analysis", "theses": "thesis",
    "crises": "crisis", "hypotheses": "hypothesis", "lives": "life",
    "wives": "wife", "knives": "knife", "leaves": "leaf", "halves": "half",
    "selves": "self", "shelves": "shelf", "wolves": "wolf",
    "indices": "index", "matrices": "matrix", "vertices": "vertex",
    "appendices": "appendix", "media": "medium", "bacteria": "bacterium",
    # comparatives / superlatives
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
    "further": "far", "farther": "far", "less": "little", "least": "little",
    "more": "much", "most": "much",
}

# compact common-lemma lexicon used to VALIDATE detachment candidates —
# the morphy pattern: a rule only fires if its output is a known word
_LEXICON = frozenset("""
be have do say get make go know take see come think look want give use
find tell ask work seem feel try leave call need become mean keep let
begin help talk turn start show hear play run move like live believe
hold bring happen write provide sit stand lose pay meet include continue
set learn change lead understand watch follow stop create speak read
allow add spend grow open walk win offer remember love consider appear
buy wait serve die send expect build stay fall cut reach kill remain
suggest raise pass sell require report decide pull return explain hope
develop carry break receive agree support hit produce eat cover catch
draw choose cause point listen realize place close involve increase wish
fly argue own pick study save share visit note state seek test fit issue
free judge drop plan drive teach check claim form fill act miss book fix
time year way day man thing woman life child world school family student
group country problem hand part place case week company system program
question government number night point home water room mother area money
story fact month lot right book eye job word business side kind head
house service friend father power hour game line end member law car city
community name president team minute idea body information back parent
face others level office door health person art war history party result
change morning reason research girl guy moment air teacher force
education foot boy age policy process music market sense nation plan
college interest death experience effect use class control care field
development role effort rate heart drug show leader light voice wife
machine image code type note test file user data value model text input
output image run state space list item table term base score post site
link page view news group net mail address message board topic thread
good new first last long great little own other old right big high
different small large next early young important few public bad same
able free true full special easy clear recent certain strong possible
late general human local sure real simple hard major better economic
current low common poor natural significant similar hot dead central
happy serious ready available likely short single medical dark various
entire close legal religious cold final main green nice huge popular
traditional cultural wide deep fast red white black blue wrong strange
safe rich fair weak direct open
ride smile dance hope bake race trade vote shine slide glide hide wave
save name tape note date rate hate gaze blame frame phrase praise raise
curse nurse argue value issue pursue rescue tie lie dye move prove love
solve serve curve carve merge urge charge change orange arrange manage
damage image voyage store score snore ignore explore restore bounce
pounce announce pronounce balance advance silence notice practice slice
price surface promise house mouse excuse refuse confuse amuse accuse
pause cause clause cease increase decrease release lease please tease
breathe bathe clothe scrape escape shape smoke poke joke stroke strike
like bike hike invite excite unite write quote vote devote promote
complete compete delete create relate debate locate rotate operate
separate update estimate generate iterate calculate populate simulate
hero potato tomato echo veto torpedo zero bus gas plus virus focus bonus
campus status circus genius radius chorus minus walrus octopus
wish push crash flash brush crush finish publish polish punish vanish
establish furnish banish cherish flourish nourish astonish diminish
accomplish distinguish extinguish
seed need feed speed breed greed deed weed bleed creed exceed proceed
succeed agree free flee tree knee degree guarantee shoe toe hoe canoe
cry dry fry spy marry bury copy empty apply reply supply imply comply
multiply occupy vary envy pity deny defy rely satisfy qualify classify
identify specify modify notify justify simplify clarify verify worry
hurry bully rally tally delay enjoy employ destroy annoy obey pray stray
jump swim grab hug ship shop chat clap jog nod pat rob rub skip slip snap
tap trap trim wrap swap scan scrub drag beg bet dim fan grin hop jam
knit map mop mug nap pad peg pin plug pop prop quit rip shrug sip skim
slam slap slot span spot stem stir strap strip tan tip tug whip zip
""".split())

# invariant forms that end in rule suffixes but must never be stemmed
# ("news" → "new" was a real regression caught by the held-out word list)
_INVARIANT = frozenset(
    "news species series means physics mathematics economics politics "
    "statistics athletics ethics headquarters measles diabetes "
    "sheep deer fish swine aircraft indeed".split()
)

# (suffix, replacement, fallback_ok) detachment rules, tried in order;
# the first rule whose candidate survives orthographic repair +
# lexicon/shape checks wins. The paired strip/+e forms are morphy's
# actual verb rule set — ("ed","e")/("ing","e") restore silent e without
# the CVC guesswork an orthographic-only repair needs ("created" →
# "creat"+CVC blocked, but rule "ed"→"e" proposes "create" directly).
# ``fallback_ok`` marks rules whose stem is a sane default for
# out-of-lexicon words: restoration rules for noun suffixes ("clues" →
# "clue", "puppies" → "puppy") and BARE strips for -ed/-ing (an
# unvalidated "+e" verb guess like "jumped" → "jumpe" is worse than the
# strip "jump").
_DETACH = (
    ("sses", "ss", True), ("ches", "ch", True), ("shes", "sh", True),
    ("xes", "x", True), ("zes", "z", True), ("ies", "y", True),
    ("ied", "y", True), ("ves", "f", True), ("oes", "o", True),
    # +e BEFORE bare strip: a CVC verb doubles its consonant before
    # -ed/-ing ("hopped"), so an undoubled stem ("hoped" → "hop") means
    # the lemma had a silent e — validation rejects "+e" when wrong
    # ("visited" → "visite" fails, falls through to "visit")
    ("ing", "e", False), ("ing", "", True), ("edly", "", True),
    ("ed", "e", False), ("ed", "", True),
    ("est", "", True), ("er", "", True),
    ("ly", "", True), ("es", "e", True), ("es", "", True),
    ("s", "", True),
)

_VOWELS = set("aeiou")


def _repair(stem: str) -> list[str]:
    """Orthographic candidates after a strip: as-is, undoubled, +e."""
    out = [stem]
    if (
        len(stem) >= 3
        and stem[-1] == stem[-2]
        and stem[-1] not in "lsz"
        and stem[-1] not in _VOWELS
    ):
        out.append(stem[:-1])  # running → runn → run
    if (
        len(stem) >= 3
        and stem[-1] not in _VOWELS
        and stem[-1] not in "wxy"
        and stem[-2] in _VOWELS
        and stem[-3] not in _VOWELS
    ):
        out.append(stem + "e")  # mak → make, writ → write
    return out


def default_lemmatize(token: str) -> str:
    """Morphy-style lemmatization: exceptions → detachment rules with
    orthographic repair, candidates validated against the lexicon; falls
    back to the plain strip when nothing validates."""
    t = token.lower()
    if t in _IRREGULAR:
        return _IRREGULAR[t]
    if t in _INVARIANT or t in _LEXICON or len(t) < 4 or not t.isalpha():
        return t
    fallback = None
    for suffix, repl, fallback_ok in _DETACH:
        if not t.endswith(suffix) or len(t) - len(suffix) < 2:
            continue
        stem = t[: len(t) - len(suffix)] + repl
        for cand in _repair(stem):
            if cand in _LEXICON or cand in _IRREGULAR:
                return _IRREGULAR.get(cand, cand)
        if fallback is None and len(stem) >= 3 and fallback_ok:
            fallback = stem
    return fallback if fallback is not None else t


# ---------------------------------------------------------------------------
# NER: gazetteers + cues (entity token → TYPE, like the reference)
# ---------------------------------------------------------------------------

_FIRST_NAMES = frozenset("""
james john robert michael william david richard joseph thomas charles
mary patricia jennifer linda elizabeth barbara susan jessica sarah karen
christopher daniel paul mark donald george kenneth steven edward brian
ronald anthony kevin jason matthew gary timothy jose larry jeffrey frank
scott eric stephen andrew raymond gregory joshua jerry dennis walter
nancy lisa margaret betty sandra ashley dorothy kimberly emily donna
michelle carol amanda melissa deborah stephanie rebecca laura sharon
cynthia kathleen amy shirley angela helen anna brenda pamela nicole
peter henry carl arthur ryan roger joe juan jack albert jonathan justin
terry gerald keith samuel willie ralph lawrence nicholas roy benjamin
bruce brandon adam harry fred billy steve louis jeremy aaron randy
emma olivia sophia isabella charlotte amelia harper evelyn abigail
alexander sebastian jacob ethan noah liam mason logan lucas
""".split())

_LOCATIONS = frozenset("""
america usa us uk england britain france germany italy spain russia
china japan india canada mexico brazil australia egypt israel iran iraq
turkey greece poland sweden norway denmark finland netherlands belgium
switzerland austria ireland scotland wales portugal ukraine korea
vietnam thailand indonesia philippines pakistan afghanistan syria
london paris berlin rome madrid moscow beijing tokyo delhi toronto
chicago boston seattle denver houston dallas atlanta miami detroit
philadelphia phoenix washington york angeles francisco vegas orleans
texas california florida virginia georgia ohio michigan arizona oregon
colorado nevada utah alaska hawaii kansas iowa maine montana idaho
europe asia africa antarctica earth
""".split())

_ORG_SUFFIXES = frozenset(
    "inc corp ltd co company corporation university institute college "
    "association committee department agency ministry bureau council "
    "bank group labs laboratories foundation society press times".split()
)

_MONTHS = frozenset(
    "january february march april may june july august september october "
    "november december jan feb mar apr jun jul aug sep sept oct nov "
    "dec".split()
)
_WEEKDAYS = frozenset(
    "monday tuesday wednesday thursday friday saturday sunday".split()
)
_HONORIFICS = frozenset(
    "mr mrs ms dr prof sir president senator judge captain general".split()
)
_NUMBER_WORDS = frozenset(
    "zero one two three four five six seven eight nine ten eleven twelve "
    "twenty thirty forty fifty sixty seventy eighty ninety hundred "
    "thousand million billion".split()
)

_ACRONYM_STOP = frozenset(
    "imho fyi faq asap btw aka diy lol irc ftp god ok yes no not and "
    "the you are was".split()
)

_YEAR_RE = re.compile(r"^[12]\d{3}$")
_NUM_RE = re.compile(r"^[+-]?\d+([.,]\d+)*(th|st|nd|rd)?$")


def _is_cap(tok: str) -> bool:
    return len(tok) > 1 and tok[0].isupper() and tok[1:].islower()


def tag_entities(tokens: list[str]) -> list[str]:
    """Per-token entity types ("O" for none) over one sentence — the shape
    of the reference's ``s.entities`` array."""
    tags = ["O"] * len(tokens)
    for i, tok in enumerate(tokens):
        low = tok.lower().strip(".")
        if _NUM_RE.match(tok) and not _YEAR_RE.match(tok):
            tags[i] = "NUMBER"
        elif low in _NUMBER_WORDS:
            tags[i] = "NUMBER"
        elif _YEAR_RE.match(tok) or low in _MONTHS or low in _WEEKDAYS:
            tags[i] = "DATE"
    for i, tok in enumerate(tokens):
        if tags[i] != "O" or not (_is_cap(tok) or tok.isupper()):
            continue
        low = tok.lower().strip(".,;:")
        prev = tokens[i - 1].lower().strip(".") if i else ""
        if low in _ORG_SUFFIXES and i and tags[i - 1] in (
            "O", "ORGANIZATION", "MISC", "PERSON",
        ):
            # suffix cue colors the preceding capitalized run (overriding
            # weaker MISC/PERSON guesses: "Acme Corp", "Smith Inc")
            tags[i] = "ORGANIZATION"
            j = i - 1
            while j >= 0 and (_is_cap(tokens[j]) or tokens[j].isupper()):
                tags[j] = "ORGANIZATION"
                j -= 1
        elif low in _LOCATIONS:
            tags[i] = "LOCATION"
        elif low in _FIRST_NAMES or prev in _HONORIFICS:
            tags[i] = "PERSON"
            # surname: following capitalized token
            if i + 1 < len(tokens) and _is_cap(tokens[i + 1]):
                tags[i + 1] = "PERSON"
        elif (
            tok.isupper()
            and 2 <= len(tok) <= 4
            and tok.isalpha()
            and low not in _ACRONYM_STOP
            and low not in _LEXICON
        ):
            # short unknown acronym → ORGANIZATION. Deliberately narrow:
            # shouted common words ("WINDOWS", "GOD") and discourse
            # acronyms must stay as ordinary, class-discriminative tokens
            # — the reference's NER only replaces recognized entities
            tags[i] = "ORGANIZATION"
    return tags


# ---------------------------------------------------------------------------
# Sentence splitting + the extractor
# ---------------------------------------------------------------------------

_ABBREV = frozenset(
    "mr mrs ms dr prof sr jr st vs etc inc corp ltd co eg ie al fig "
    "e.g i.e u.s u.k".split()
)
_TOKEN_RE = re.compile(r"[A-Za-z0-9][\w.'+-]*|[.!?]")


def split_sentences(text: str) -> list[list[str]]:
    """Tokenize into sentences: terminators split unless the previous
    token is a known abbreviation, a single initial, or a dotted form
    (e.g. "U.S.")."""
    sentences: list[list[str]] = []
    cur: list[str] = []
    toks: list[str] = []
    for tok in _TOKEN_RE.findall(text):
        # the word pattern absorbs a trailing period ("sat." is one
        # match): split it back out unless it marks an abbreviation
        body = tok.rstrip(".")
        if (
            tok.endswith(".")
            and body
            and "." not in body
            and len(body) > 1
            and body.lower() not in _ABBREV
        ):
            toks.extend([body, "."])
        else:
            toks.append(tok)
    for tok in toks:
        if tok in ".!?":
            if cur:
                sentences.append(cur)
                cur = []
        elif tok:
            cur.append(tok.rstrip("."))
    if cur:
        sentences.append(cur)
    return sentences


_NORMALIZE_RE = re.compile(r"[^a-zA-Z0-9\s+]")


def _normalize(s: str) -> str:
    """The reference's normalize: strip [^a-zA-Z0-9\\s+], lowercase."""
    return _NORMALIZE_RE.sub("", s).lower()


@dataclasses.dataclass(eq=False)
class CoreNLPFeatureExtractor(Transformer):
    """Documents → per-sentence n-grams of lemmatized, entity-typed tokens
    (reference CoreNLPFeatureExtractor.scala:21-45: each entity token is
    replaced by its TYPE, other tokens by their normalized lemma; n-grams
    are space-joined and respect sentence boundaries)."""

    orders: tuple = (1, 2)

    def __call__(self, batch):
        docs = [batch] if isinstance(batch, str) else batch
        out = []
        for doc in docs:
            sentences = []
            for toks in split_sentences(doc):
                tags = tag_entities(toks)
                sentences.append(
                    [
                        tag if tag != "O" else _normalize(default_lemmatize(t))
                        for t, tag in zip(toks, tags)
                    ]
                )
            grams = []
            for n in self.orders:
                for s in sentences:
                    grams.extend(
                        " ".join(s[i : i + n])
                        for i in range(len(s) - n + 1)
                    )
            out.append(grams)
        return out[0] if isinstance(batch, str) else out
