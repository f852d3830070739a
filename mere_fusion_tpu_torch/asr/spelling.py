"""British -> American spelling normalization for WER comparisons.

Port of mere_fusion_tpu/asr/spelling.py: plain Python, copied.

The reference vendors the tysto.com UK->US spelling list as a 1,740-entry
JSON table (reference: musetalk/whisper/whisper/normalizers/english.json,
loaded by normalizers/english.py:443-455).  The dominant pattern in that
public wordlist is an "s"->"z" swap on a verb stem carried through its
inflections (accessorise/-es/-ed/-ing -> accessorize/...), so instead of a
flat table we store the ~230 stems once and generate the inflections,
keeping only the genuinely irregular pairs explicit.  The parity test
asserts the generated mapping reproduces every entry of the reference
table exactly (tests/test_normalizers.py).

Data source: the public tysto.com UK-US spelling list (the same source the
reference credits).
"""
from __future__ import annotations

from functools import lru_cache

# UK stems whose "s" becomes "z" before e/es/ed/ing (tysto.com list,
# compressed to stems; inflections are generated).
_SZ_STEMS = """\
accessori acclimati aggrandi agoni amorti analy anglici annuali antagoni
apologi appeti authori bapti bastardi bowdleri breathaly brutali canali
cannibali canoni capitali carameli carboni cataly categori cauteri
centrali characteri circulari civili co collectivi coloni commerciali
compartmentali computeri conceptuali contextuali criminali critici
crystalli customi decentrali decriminali dehumani demilitari demobili
democrati demoni demorali denationali deodori depersonali deputi desensiti
destabili digiti disorgani dramati economi editoriali empathi emphasi
energi epitomi equali eulogi evangeli exorci extempori externali factori
familiari fantasi femini fertili fictionali finali formali fossili
fraterni galvani generali ghettoi glamori globali harmoni homogeni
hospitali humani hybridi hypnoti hypothesi ideali idoli immobili immortali
immuni individuali industriali initiali institutionali intellectuali
internali internationali ioni italici itemi jeopardi legali legitimi
liberali lioni liquidi locali magneti marginali materiali maximi mechani
memori memoriali mesmeri metaboli militari miniaturi minimi mobili moderni
moisturi monopoli morali motori nationali naturali neutrali normali optimi
organi ostraci overemphasi oxidi paraly particulari passivi pasteuri
patroni pedestriani penali personali philosophi plagiari polari politici
populari pressuri prioriti privati professionali propagandi proselyti
psychoanaly publici pulveri radicali randomi rationali reali recogni
regulari reorgani revitali revolutioni rhapsodi rituali romantici saniti
satiri scandali scrutini seculari sensationali sensiti sentimentali
seriali sermoni signali sociali sodomi solemni speciali stabili standardi
sterili stigmati subsidi summari symboli sympathi synchroni synthesi
systemati tantali tempori tenderi terrori theori transistori traumati
triviali tyranni unauthori uncivili underutili unioni unorgani unrecogni
urbani utili vandali vapori verbali victimi visuali vocali vulcani vulgari
westerni womani
""".split()

# stems with additional derived forms present in the source list
_SZ_EXTRA = {
    "able": """\
amorti reali recogni unrecogni utili
""".split(),
    "ably": """\
recogni
""".split(),
    "ance": """\
recogni
""".split(),
    "ation": """\
acclimati amorti coloni crystalli decentrali decriminali dehumani
demilitari demobili democrati demorali denationali desensiti destabili
disorgani dramati equali extempori externali familiari fertili fictionali
finali formali fossili fraterni generali globali harmoni hospitali ideali
immobili immuni institutionali internali internationali ioni legali
liberali lioni marginali materiali maximi mechani miniaturi mobili
monopoli nationali naturali neutrali normali organi oxidi passivi pasteuri
pedestriani polari politici populari pressuri prioriti privati
professionali pulveri rationali reali regulari reorgani seculari seriali
sociali speciali stabili standardi sterili stigmati subsidi synchroni
systemati unioni urbani utili vapori victimi visuali vocali vulgari
westerni
""".split(),
    "ational": """\
organi
""".split(),
    "ations": """\
amorti dramati externali fictionali generali nationali organi privati
rationali reali reorgani seriali speciali sterili visuali vocali
""".split(),
    "ement": """\
aggrandi
""".split(),
    "er": """\
appeti breathaly coloni equali fertili immobili ioni liquidi moisturi
organi proselyti stabili sterili subsidi sympathi synthesi womani
""".split(),
    "ers": """\
appeti breathaly coloni equali fertili immobili ioni liquidi moisturi
organi proselyti stabili sterili subsidi sympathi synthesi womani
""".split(),
    "ier": """\
co
""".split(),
    "ies": """\
co
""".split(),
    "iest": """\
co
""".split(),
    "ily": """\
co
""".split(),
    "iness": """\
co
""".split(),
    "ingly": """\
agoni appeti patroni tantali
""".split(),
    "y": """\
co
""".split(),
}

# remaining UK -> US pairs that do not follow the s->z stem pattern
_PAIRS = {
    "accoutrements": "accouterments", "aeon": "eon", "aeons": "eons",
    "aerogramme": "aerogram", "aerogrammes": "aerograms",
    "aeroplane": "airplane", "aeroplanes": "airplanes",
    "aesthete": "esthete", "aesthetes": "esthetes", "aesthetic": "esthetic",
    "aesthetically": "esthetically", "aesthetics": "esthetics",
    "aetiology": "etiology", "ageing": "aging", "almanack": "almanac",
    "almanacks": "almanacs", "aluminium": "aluminum",
    "amphitheatre": "amphitheater", "amphitheatres": "amphitheaters",
    "anaemia": "anemia", "anaemic": "anemic", "anaesthesia": "anesthesia",
    "anaesthetic": "anesthetic", "anaesthetics": "anesthetics",
    "anaesthetise": "anesthetize", "anaesthetised": "anesthetized",
    "anaesthetises": "anesthetizes", "anaesthetising": "anesthetizing",
    "anaesthetist": "anesthetist", "anaesthetists": "anesthetists",
    "anaesthetize": "anesthetize", "anaesthetized": "anesthetized",
    "anaesthetizes": "anesthetizes", "anaesthetizing": "anesthetizing",
    "analogue": "analog", "analogues": "analogs", "appal": "appall",
    "appals": "appalls", "arbour": "arbor", "arbours": "arbors",
    "archeological": "archaeological", "archaeologically": "archeologically",
    "archaeologist": "archeologist", "archaeologists": "archeologists",
    "archaeology": "archeology</span>", "ardour": "ardor", "armour": "armor",
    "armoured": "armored", "armourer": "armorer", "armourers": "armorers",
    "armouries": "armories", "armoury": "armory", "artefact": "artifact",
    "artefacts": "artifacts", "axe": "ax", "backpedalled": "backpedaled",
    "backpedalling": "backpedaling", "bannister": "banister",
    "bannisters": "banisters", "battleax": "battleaxe", "baulk": "balk",
    "baulked": "balked", "baulking": "balking", "baulks": "balks",
    "bedevilled": "bedeviled", "bedevilling": "bedeviling",
    "behaviour": "behavior", "behavioural": "behavioral",
    "behaviourism": "behaviorism", "behaviourist": "behaviorist",
    "behaviourists": "behaviorists", "behaviours": "behaviors",
    "behove": "behoove", "behoved": "behooved", "behoves": "behooves",
    "bejewelled": "bejeweled", "belabour": "belabor",
    "belaboured": "belabored", "belabouring": "belaboring",
    "belabours": "belabors", "bevelled": "beveled", "bevvies": "bevies",
    "bevvy": "bevy", "biassed": "biased", "biassing": "biasing",
    "bingeing": "binging", "bougainvillaea": "bougainvillea",
    "bougainvillaeas": "bougainvilleas", "busses": "buses",
    "bussing": "busing", "caesarean": "cesarean", "caesareans": "cesareans",
    "calibre": "caliber", "calibres": "calibers", "calliper": "caliper",
    "callipers": "calipers", "callisthenics": "calisthenics",
    "cancelation": "cancellation", "cancelations": "cancellations",
    "cancelled": "canceled", "cancelling": "canceling", "candour": "candor",
    "carolled": "caroled", "carolling": "caroling", "catalogue": "catalog",
    "catalogued": "cataloged", "catalogues": "catalogs",
    "cataloguing": "cataloging", "cavilled": "caviled",
    "cavilling": "caviling", "centigramme": "centigram",
    "centigrammes": "centigrams", "centilitre": "centiliter",
    "centilitres": "centiliters", "centimetre": "centimeter",
    "centimetres": "centimeters", "centre": "center", "centred": "centered",
    "centrefold": "centerfold", "centrefolds": "centerfolds",
    "centrepiece": "centerpiece", "centrepieces": "centerpieces",
    "centres": "centers", "channelled": "channeled",
    "channelling": "channeling", "cheque": "check",
    "chequebook": "checkbook", "chequebooks": "checkbooks",
    "chequered": "checkered", "cheques": "checks", "chilli": "chili",
    "chimaera": "chimera", "chimaeras": "chimeras", "chiselled": "chiseled",
    "chiselling": "chiseling", "clamour": "clamor", "clamoured": "clamored",
    "clamouring": "clamoring", "clamours": "clamors", "clangour": "clangor",
    "clarinettist": "clarinetist", "clarinettists": "clarinetists",
    "colour": "color", "colourant": "colorant", "colourants": "colorants",
    "coloured": "colored", "coloureds": "coloreds", "colourful": "colorful",
    "colourfully": "colorfully", "colouring": "coloring",
    "colourize": "colorize", "colourized": "colorized",
    "colourizes": "colorizes", "colourizing": "colorizing",
    "colourless": "colorless", "colours": "colors",
    "connexion": "connection", "connexions": "connections",
    "councillor": "councilor", "councillors": "councilors",
    "counselled": "counseled", "counselling": "counseling",
    "counsellor": "counselor", "counsellors": "counselors",
    "crenelated": "crenellated", "crueller": "crueler",
    "cruellest": "cruelest", "cudgelled": "cudgeled",
    "cudgelling": "cudgeling", "cypher": "cipher", "cyphers": "ciphers",
    "defence": "defense", "defenceless": "defenseless",
    "defences": "defenses", "demeanour": "demeanor", "dialled": "dialed",
    "dialling": "dialing", "dialogue": "dialog", "dialogues": "dialogs",
    "diarrhoea": "diarrhea", "disc": "disk", "discolour": "discolor",
    "discoloured": "discolored", "discolouring": "discoloring",
    "discolours": "discolors", "discs": "disks",
    "disembowelled": "disemboweled", "disembowelling": "disemboweling",
    "disfavour": "disfavor", "dishevelled": "disheveled",
    "dishonour": "dishonor", "dishonourable": "dishonorable",
    "dishonourably": "dishonorably", "dishonoured": "dishonored",
    "dishonouring": "dishonoring", "dishonours": "dishonors",
    "distil": "distill", "distils": "distills", "draught": "draft",
    "draughtboard": "draftboard", "draughtboards": "draftboards",
    "draughtier": "draftier", "draughtiest": "draftiest",
    "draughts": "drafts", "draughtsman": "draftsman",
    "draughtsmanship": "draftsmanship", "draughtsmen": "draftsmen",
    "draughtswoman": "draftswoman", "draughtswomen": "draftswomen",
    "draughty": "drafty", "drivelled": "driveled", "drivelling": "driveling",
    "duelled": "dueled", "duelling": "dueling", "edoema": "edema",
    "enamelled": "enameled", "enamelling": "enameling",
    "enamoured": "enamored", "encyclopaedia": "encyclopedia",
    "encyclopaedias": "encyclopedias", "encyclopaedic": "encyclopedic",
    "endeavour": "endeavor", "endeavoured": "endeavored",
    "endeavouring": "endeavoring", "endeavours": "endeavors",
    "enrol": "enroll", "enrols": "enrolls", "enthral": "enthrall",
    "enthrals": "enthralls", "epaulette": "epaulet",
    "epaulettes": "epaulets", "epicentre": "epicenter",
    "epicentres": "epicenters", "epilogue": "epilog", "epilogues": "epilogs",
    "faecal": "fecal", "faeces": "feces", "favour": "favor",
    "favourable": "favorable", "favourably": "favorably",
    "favoured": "favored", "favouring": "favoring", "favourite": "favorite",
    "favourites": "favorites", "favouritism": "favoritism",
    "favours": "favors", "fervour": "fervor", "fibre": "fiber",
    "fibreglass": "fiberglass", "fibres": "fibers", "fillet": "filet",
    "filleted": "fileted", "filleting": "fileting", "fillets": "filets",
    "flautist": "flutist", "flautists": "flutists", "flavour": "flavor",
    "flavoured": "flavored", "flavouring": "flavoring",
    "flavourings": "flavorings", "flavourless": "flavorless",
    "flavours": "flavors", "flavoursome": "flavorsome",
    "flyer / flier": "flier / flyer", "foetal": "fetal", "foetid": "fetid",
    "foetus": "fetus", "foetuses": "fetuses", "fulfil": "fulfill",
    "fulfilment": "fulfillment", "fulfils": "fulfills",
    "funnelled": "funneled", "funnelling": "funneling",
    "gambolled": "gamboled", "gambolling": "gamboling", "gaol": "jail",
    "gaolbird": "jailbird", "gaolbirds": "jailbirds",
    "gaolbreak": "jailbreak", "gaolbreaks": "jailbreaks", "gaoled": "jailed",
    "gaoler": "jailer", "gaolers": "jailers", "gaoling": "jailing",
    "gaols": "jails", "gasses": "gases", "gage": "gauge", "gaged": "gauged",
    "gages": "gauges", "gaging": "gauging", "gipsies": "gypsies",
    "glamor": "glamour", "glueing": "gluing", "goitre": "goiter",
    "goitres": "goiters", "gonorrhoea": "gonorrhea", "gramme": "gram",
    "grammes": "grams", "gravelled": "graveled", "grey": "gray",
    "greyed": "grayed", "greying": "graying", "greyish": "grayish",
    "greyness": "grayness", "greys": "grays", "grovelled": "groveled",
    "grovelling": "groveling", "groyne": "groin", "groynes": "groins",
    "gruelling": "grueling", "gruellingly": "gruelingly",
    "gryphon": "griffin", "gryphons": "griffins",
    "gynaecological": "gynecological", "gynaecologist": "gynecologist",
    "gynaecologists": "gynecologists", "gynaecology": "gynecology",
    "haematological": "hematological", "haematologist": "hematologist",
    "haematologists": "hematologists", "haematology": "hematology",
    "haemoglobin": "hemoglobin", "haemophilia": "hemophilia",
    "haemophiliac": "hemophiliac", "haemophiliacs": "hemophiliacs",
    "haemorrhage": "hemorrhage", "haemorrhaged": "hemorrhaged",
    "haemorrhages": "hemorrhages", "haemorrhaging": "hemorrhaging",
    "haemorrhoids": "hemorrhoids", "harbour": "harbor",
    "harboured": "harbored", "harbouring": "harboring",
    "harbours": "harbors", "homoeopath": "homeopath",
    "homoeopathic": "homeopathic", "homoeopaths": "homeopaths",
    "homoeopathy": "homeopathy", "honour": "honor",
    "honourable": "honorable", "honourably": "honorably",
    "honoured": "honored", "honouring": "honoring", "honours": "honors",
    "humour": "humor", "humoured": "humored", "humouring": "humoring",
    "humourless": "humorless", "humours": "humors",
    "impanelled": "impaneled", "impanelling": "impaneling",
    "imperilled": "imperiled", "imperilling": "imperiling",
    "inflexion": "inflection", "inflexions": "inflections",
    "initialled": "initialed", "initialling": "initialing",
    "instal": "install", "instalment": "installment",
    "instalments": "installments", "instals": "installs",
    "instil": "instill", "instils": "instills", "jewelled": "jeweled",
    "jeweller": "jeweler", "jewellers": "jewelers", "jewellery": "jewelry",
    "judgement": "judgment", "kilogramme": "kilogram",
    "kilogrammes": "kilograms", "kilometre": "kilometer",
    "kilometres": "kilometers", "labelled": "labeled",
    "labelling": "labeling", "labour": "labor", "laboured": "labored",
    "labourer": "laborer", "labourers": "laborers", "labouring": "laboring",
    "labours": "labors", "lacklustre": "lackluster", "leukaemia": "leukemia",
    "levelled": "leveled", "leveller": "leveler", "levellers": "levelers",
    "levelling": "leveling", "libelled": "libeled", "libelling": "libeling",
    "libellous": "libelous", "licence": "license", "licenced": "licensed",
    "licences": "licenses", "licencing": "licensing", "likeable": "likable",
    "litre": "liter", "litres": "liters", "louvre": "louver",
    "louvred": "louvered", "louvres": "louvers", "lustre": "luster",
    "manoeuvrability": "maneuverability", "manoeuvrable": "maneuverable",
    "manoeuvre": "maneuver", "manoeuvred": "maneuvered",
    "manoeuvres": "maneuvers", "manoeuvring": "maneuvering",
    "manoeuvrings": "maneuverings", "marshalled": "marshaled",
    "marshalling": "marshaling", "marvelled": "marveled",
    "marvelling": "marveling", "marvellous": "marvelous",
    "marvellously": "marvelously", "meagre": "meager",
    "mediaeval": "medieval", "metre": "meter", "metres": "meters",
    "micrometre": "micrometer", "micrometres": "micrometers",
    "milligramme": "milligram", "milligrammes": "milligrams",
    "millilitre": "milliliter", "millilitres": "milliliters",
    "millimetre": "millimeter", "millimetres": "millimeters",
    "minibusses": "minibuses", "misbehaviour": "misbehavior",
    "misdemeanour": "misdemeanor", "misdemeanours": "misdemeanors",
    "misspelt": "misspelled", "mitre": "miter", "mitres": "miters",
    "modelled": "modeled", "modeller": "modeler", "modellers": "modelers",
    "modelling": "modeling", "monologue": "monolog",
    "monologues": "monologs", "mould": "mold", "moulded": "molded",
    "moulder": "molder", "mouldered": "moldered", "mouldering": "moldering",
    "moulders": "molders", "mouldier": "moldier", "mouldiest": "moldiest",
    "moulding": "molding", "mouldings": "moldings", "moulds": "molds",
    "mouldy": "moldy", "moult": "molt", "moulted": "molted",
    "moulting": "molting", "moults": "molts", "moustache": "mustache",
    "moustached": "mustached", "moustaches": "mustaches",
    "moustachioed": "mustachioed", "multicoloured": "multicolored",
    "neighbour": "neighbor", "neighbourhood": "neighborhood",
    "neighbourhoods": "neighborhoods", "neighbouring": "neighboring",
    "neighbourliness": "neighborliness", "neighbourly": "neighborly",
    "neighbours": "neighbors", "odour": "odor", "odourless": "odorless",
    "odours": "odors", "oesophagus": "esophagus",
    "oesophaguses": "esophaguses", "oestrogen": "estrogen",
    "offence": "offense", "offences": "offenses", "omelette": "omelet",
    "omelettes": "omelets", "orthopaedic": "orthopedic",
    "orthopaedics": "orthopedics", "outmanoeuvre": "outmaneuver",
    "outmanoeuvred": "outmaneuvered", "outmanoeuvres": "outmaneuvers",
    "outmanoeuvring": "outmaneuvering", "paederast": "pederast",
    "paederasts": "pederasts", "paediatric": "pediatric",
    "paediatrician": "pediatrician", "paediatricians": "pediatricians",
    "paediatrics": "pediatrics", "paedophile": "pedophile",
    "paedophiles": "pedophiles", "paedophilia": "pedophilia",
    "palaeolithic": "paleolithic", "palaeontologist": "paleontologist",
    "palaeontologists": "paleontologists", "palaeontology": "paleontology",
    "panelled": "paneled", "panelling": "paneling", "panellist": "panelist",
    "panellists": "panelists", "parcelled": "parceled",
    "parcelling": "parceling", "parlour": "parlor", "parlours": "parlors",
    "pedalled": "pedaled", "pedalling": "pedaling", "pencilled": "penciled",
    "pencilling": "penciling", "pharmacopoeia": "pharmacopeia",
    "pharmacopoeias": "pharmacopeias", "philtre": "filter",
    "philtres": "filters", "phoney": "phony", "plough": "plow",
    "ploughed": "plowed", "ploughing": "plowing", "ploughman": "plowman",
    "ploughmen": "plowmen", "ploughs": "plows", "ploughshare": "plowshare",
    "ploughshares": "plowshares", "pouffe": "pouf", "pouffes": "poufs",
    "practise": "practice", "practised": "practiced",
    "practises": "practices", "practising": "practicing",
    "praesidium": "presidium", "praesidiums": "presidiums",
    "pretence": "pretense", "pretences": "pretenses",
    "primaeval": "primeval", "programme": "program",
    "programmes": "programs", "prologue": "prolog", "prologues": "prologs",
    "pummelled": "pummel", "pummelling": "pummeled", "pyjama": "pajama",
    "pyjamas": "pajamas", "pzazz": "pizzazz", "quarrelled": "quarreled",
    "quarrelling": "quarreling", "rancour": "rancor", "ravelled": "raveled",
    "ravelling": "raveling", "reconnoitre": "reconnoiter",
    "reconnoitred": "reconnoitered", "reconnoitres": "reconnoiters",
    "reconnoitring": "reconnoitering", "refuelled": "refueled",
    "refuelling": "refueling", "remodelled": "remodeled",
    "remodelling": "remodeling", "remould": "remold",
    "remoulded": "remolded", "remoulding": "remolding",
    "remoulds": "remolds", "revelled": "reveled", "reveller": "reveler",
    "revellers": "revelers", "revelling": "reveling", "rigour": "rigor",
    "rigours": "rigors", "rivalled": "rivaled", "rivalling": "rivaling",
    "rumour": "rumor", "rumoured": "rumored", "rumours": "rumors",
    "sabre": "saber", "sabres": "sabers", "saltpetre": "saltpeter",
    "saviour": "savior", "saviours": "saviors", "savour": "savor",
    "savoured": "savored", "savouries": "savories", "savouring": "savoring",
    "savours": "savors", "savoury": "savory", "sceptic": "skeptic",
    "sceptical": "skeptical", "sceptically": "skeptically",
    "scepticism": "skepticism", "sceptics": "skeptics", "sceptre": "scepter",
    "sceptres": "scepters", "sepulchre": "sepulcher",
    "sepulchres": "sepulchers", "sheikh": "sheik", "shovelled": "shoveled",
    "shovelling": "shoveling", "shrivelled": "shriveled",
    "shrivelling": "shriveling", "signalled": "signaled",
    "signalling": "signaling", "smoulder": "smolder",
    "smouldered": "smoldered", "smouldering": "smoldering",
    "smoulders": "smolders", "snivelled": "sniveled",
    "snivelling": "sniveling", "snorkelled": "snorkeled",
    "snorkelling": "snorkeling", "snowplough": "snowplow",
    "snowploughs": "snowplow", "sombre": "somber", "spectre": "specter",
    "spectres": "specters", "spiralled": "spiraled",
    "spiralling": "spiraling", "splendour": "splendor",
    "splendours": "splendors", "squirrelled": "squirreled",
    "squirrelling": "squirreling", "stencilled": "stenciled",
    "stencilling": "stenciling", "storey": "story", "storeys": "stories",
    "succour": "succor", "succoured": "succored", "succouring": "succoring",
    "succours": "succors", "sulphate": "sulfate", "sulphates": "sulfates",
    "sulphide": "sulfide", "sulphides": "sulfides", "sulphur": "sulfur",
    "sulphurous": "sulfurous", "swivelled": "swiveled",
    "swivelling": "swiveling", "syphon": "siphon", "syphoned": "siphoned",
    "syphoning": "siphoning", "syphons": "siphons", "tasselled": "tasseled",
    "technicolour": "technicolor", "theatre": "theater",
    "theatregoer": "theatergoer", "theatregoers": "theatergoers",
    "theatres": "theaters", "tonne": "ton", "tonnes": "tons",
    "towelled": "toweled", "towelling": "toweling", "toxaemia": "toxemia",
    "tranquillise": "tranquilize", "tranquillised": "tranquilized",
    "tranquilliser": "tranquilizer", "tranquillisers": "tranquilizers",
    "tranquillises": "tranquilizes", "tranquillising": "tranquilizing",
    "tranquillity": "tranquility", "tranquillize": "tranquilize",
    "tranquillized": "tranquilized", "tranquillizer": "tranquilizer",
    "tranquillizers": "tranquilizers", "tranquillizes": "tranquilizes",
    "tranquillizing": "tranquilizing", "tranquilly": "tranquility",
    "travelled": "traveled", "traveller": "traveler",
    "travellers": "travelers", "travelling": "traveling",
    "travelog": "travelogue", "travelogs": "travelogues",
    "trialled": "trialed", "trialling": "trialing", "tricolour": "tricolor",
    "tricolours": "tricolors", "tumour": "tumor", "tumours": "tumors",
    "tunnelled": "tunneled", "tunnelling": "tunneling", "tyre": "tire",
    "tyres": "tires", "unequalled": "unequaled",
    "unfavourable": "unfavorable", "unfavourably": "unfavorably",
    "unravelled": "unraveled", "unravelling": "unraveling",
    "unrivalled": "unrivaled", "unsavoury": "unsavory",
    "untrammelled": "untrammeled", "valour": "valor", "vapour": "vapor",
    "vapours": "vapors", "videodisc": "videodisk",
    "videodiscs": "videodisks", "vigour": "vigor", "waggon": "wagon",
    "waggons": "wagons", "watercolour": "watercolor",
    "watercolours": "watercolors", "weaselled": "weaseled",
    "weaselling": "weaseling", "woollen": "woolen", "woollens": "woolens",
    "woollies": "woolies", "woolly": "wooly", "worshipped": "worshiped",
    "worshipping": "worshiping", "worshipper": "worshiper",
    "yodelled": "yodeled", "yodelling": "yodeling", "yoghourt": "yogurt",
    "yoghourts": "yogurts", "yoghurt": "yogurt", "yoghurts": "yogurts",
    "mhm": "hmm", "mm": "hmm", "mmm": "hmm",
}


@lru_cache(maxsize=1)
def uk_to_us_mapping() -> dict:
    """Expand the stem classes into the full UK->US word mapping."""
    mapping = {}
    for stem in _SZ_STEMS:
        for suffix in ("e", "es", "ed", "ing"):
            mapping[stem + "s" + suffix] = stem + "z" + suffix
    for suffix, stems in _SZ_EXTRA.items():
        for stem in stems:
            mapping[stem + "s" + suffix] = stem + "z" + suffix
    mapping.update(_PAIRS)
    return mapping


class EnglishSpellingNormalizer:
    """Word-by-word UK->US rewrite (reference: normalizers/english.py:443)."""

    def __init__(self):
        self.mapping = uk_to_us_mapping()

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())
