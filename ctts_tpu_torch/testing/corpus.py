"""The 120-utterance acceptance corpus.

Transcribed from the reference's generate_samples.sh:37-273 — its de-facto
regression suite (SURVEY.md §4): 14 feature sections, each exercising one
subsystem. Entries are (filename, text, speed).

Copy of ctts_tpu/testing/corpus.py for the PyTorch port: only the package
name in its imports and module references differs, and the C
reference is cited by its relative path.
"""

SPEED_TEST_PHRASE = "o brasil é um país muito bonito"
LONG_PHRASE = (
    "quando eu era criança, minha família morava em uma casa pequena "
    "perto do rio"
)

CORPUS = [
    # Section 1: questions (rising intonation)
    ("01_question_simple.wav", "como vai?", 1.0),
    ("02_question_name.wav", "como você se chama?", 1.0),
    ("03_question_where.wav", "onde você mora?", 1.0),
    ("04_question_what.wav", "o que é isso?", 1.0),
    ("05_question_when.wav", "quando você chega?", 1.0),
    ("06_question_why.wav", "por que você fez isso?", 1.0),
    ("07_question_how_much.wav", "quanto custa?", 1.0),
    ("08_question_long.wav",
     "você pode me ajudar a encontrar o caminho?", 1.0),
    ("09_question_yes_no.wav", "você fala português?", 1.0),
    ("10_question_choice.wav", "você prefere café ou chá?", 1.0),
    # Section 2: exclamations
    ("11_exclaim_wow.wav", "que legal!", 1.0),
    ("12_exclaim_great.wav", "muito bom!", 1.0),
    ("13_exclaim_amazing.wav", "isso é incrível!", 1.0),
    ("14_exclaim_help.wav", "me ajuda!", 1.0),
    ("15_exclaim_stop.wav", "para com isso!", 1.0),
    ("16_exclaim_beautiful.wav", "que lindo!", 1.0),
    ("17_exclaim_delicious.wav", "que delícia!", 1.0),
    ("18_exclaim_congrats.wav", "parabéns!", 1.0),
    ("19_exclaim_welcome.wav", "bem vindo!", 1.0),
    ("20_exclaim_long.wav", "eu não acredito que isso aconteceu!", 1.0),
    # Section 3: comma pauses
    ("21_comma_list.wav", "eu quero café, pão, e manteiga", 1.0),
    ("22_comma_address.wav", "olá, como vai você", 1.0),
    ("23_comma_but.wav", "eu queria ir, mas não posso", 1.0),
    ("24_comma_therefore.wav", "ele estudou muito, portanto passou", 1.0),
    ("25_comma_series.wav", "vermelho, azul, verde, e amarelo", 1.0),
    ("26_comma_clause.wav", "quando chegar em casa, me liga", 1.0),
    ("27_comma_name.wav", "Maria, você pode vir aqui", 1.0),
    ("28_comma_yes.wav", "sim, eu entendo", 1.0),
    ("29_comma_no.wav", "não, obrigado", 1.0),
    ("30_comma_complex.wav",
     "depois do almoço, vamos ao parque, e depois voltamos", 1.0),
    # Section 4: period pauses
    ("31_period_two.wav", "eu gosto de música. ela também gosta.", 1.0),
    ("32_period_three.wav", "bom dia. como vai. tudo bem.", 1.0),
    ("33_period_story.wav",
     "era uma vez. havia um rei. ele era muito bom.", 1.0),
    ("34_period_instructions.wav",
     "primeiro abra a porta. depois entre. feche a porta.", 1.0),
    ("35_period_facts.wav",
     "o brasil é grande. tem muitas cidades. são paulo é a maior.", 1.0),
    # Section 5: mixed punctuation
    ("36_mixed_question_exclaim.wav", "você viu isso? que incrível!", 1.0),
    ("37_mixed_comma_period.wav",
     "olá, tudo bem. sim, estou ótimo.", 1.0),
    ("38_mixed_all.wav", "espera, o que? não acredito! é verdade.", 1.0),
    ("39_mixed_dialogue.wav",
     "oi, como vai? bem, e você? também bem, obrigado!", 1.0),
    ("40_mixed_complex.wav",
     "primeiro, pense bem. depois, decida. está pronto? então vamos!", 1.0),
    # Section 6: number expansion
    ("41_num_single.wav", "eu tenho 5 livros", 1.0),
    ("42_num_teens.wav", "ela tem 15 anos", 1.0),
    ("43_num_tens.wav", "são 42 pessoas", 1.0),
    ("44_num_hundred.wav", "custa 100 reais", 1.0),
    ("45_num_hundreds.wav", "são 350 quilômetros", 1.0),
    ("46_num_thousand.wav", "tem 1000 lugares", 1.0),
    ("47_num_thousands.wav", "são 2500 pessoas", 1.0),
    ("48_num_year.wav", "estamos em 2024", 1.0),
    ("49_num_big.wav", "a cidade tem 12000000 habitantes", 1.0),
    ("50_num_mixed.wav", "eu tenho 3 filhos, 2 cachorros e 1 gato", 1.0),
    # Section 7: abbreviations
    ("51_abbrev_dr.wav", "Dr. Silva é médico", 1.0),
    ("52_abbrev_sra.wav", "Sra. Maria chegou", 1.0),
    ("53_abbrev_prof.wav", "Prof. João ensina matemática", 1.0),
    ("54_abbrev_units.wav", "são 5 km de distância", 1.0),
    ("55_abbrev_weight.wav", "pesa 10 kg", 1.0),
    ("56_abbrev_volume.wav", "tem 500 ml de água", 1.0),
    ("57_abbrev_month.wav", "nasceu em jan. de 1990", 1.0),
    ("58_abbrev_etc.wav", "comprei frutas, legumes, etc.", 1.0),
    ("59_abbrev_tel.wav", "meu tel. é novo", 1.0),
    ("60_abbrev_mixed.wav", "Dr. Carlos mora a 3 km daqui", 1.0),
    # Section 8: hiatus (vowel separation)
    ("61_hiato_praia.wav", "vamos para a praia", 1.0),
    ("62_hiato_maio.wav", "nasceu em maio", 1.0),
    ("63_hiato_feio.wav", "isso é muito feio", 1.0),
    ("64_hiato_joia.wav", "que joia linda", 1.0),
    ("65_hiato_apoio.wav", "preciso do seu apoio", 1.0),
    ("66_hiato_saia.wav", "ela usa saia", 1.0),
    ("67_hiato_areia.wav", "a areia é quente", 1.0),
    ("68_hiato_ideia.wav", "que boa ideia", 1.0),
    ("69_hiato_multiple.wav", "na praia, a areia é muito boa", 1.0),
    ("70_hiato_sentence.wav",
     "em maio vou para a praia com a família", 1.0),
    # Section 9: R at word start
    ("71_r_rosa.wav", "a rosa é vermelha", 1.0),
    ("72_r_rio.wav", "o rio é grande", 1.0),
    ("73_r_rato.wav", "o rato fugiu", 1.0),
    ("74_r_rua.wav", "a rua está vazia", 1.0),
    ("75_r_rei.wav", "o rei era bom", 1.0),
    ("76_r_rico.wav", "ele é muito rico", 1.0),
    ("77_r_roupa.wav", "comprei roupa nova", 1.0),
    ("78_r_rapido.wav", "ele corre rápido", 1.0),
    ("79_r_multiple.wav", "o rio rosa é raro", 1.0),
    ("80_r_sentence.wav", "o rato roeu a roupa do rei de roma", 1.0),
    # Section 10: S between vowels
    ("81_s_casa.wav", "minha casa é grande", 1.0),
    ("82_s_mesa.wav", "a mesa está posta", 1.0),
    ("83_s_rosa.wav", "a rosa cheira bem", 1.0),
    ("84_s_coisa.wav", "que coisa estranha", 1.0),
    ("85_s_preciso.wav", "eu preciso de ajuda", 1.0),
    ("86_s_música.wav", "eu amo música", 1.0),
    ("87_s_empresa.wav", "a empresa cresceu", 1.0),
    ("88_s_brasil.wav", "o brasil é lindo", 1.0),
    ("89_s_multiple.wav", "a casa rosa é preciosa", 1.0),
    ("90_s_sentence.wav", "preciso comprar coisas para casa", 1.0),
    # Section 11: word-final T
    ("91_t_internet.wav", "a internet é rápida", 1.0),
    ("92_t_eset.wav", "o set está pronto", 1.0),
    # Section 12: declination
    ("93_decl_short.wav", "eu vou ao mercado comprar frutas", 1.0),
    ("94_decl_medium.wav",
     "hoje de manhã eu acordei cedo e fui trabalhar", 1.0),
    ("95_decl_long.wav",
     "quando eu era criança minha família morava em uma casa pequena "
     "perto do rio", 1.0),
    ("96_decl_very_long.wav",
     "o brasil é um país muito grande com muitas cidades bonitas e "
     "pessoas simpáticas que adoram futebol e música", 1.0),
    # Section 13: speed variations (WSOLA)
    ("97_speed_0.5x.wav", SPEED_TEST_PHRASE, 0.5),
    ("98_speed_0.7x.wav", SPEED_TEST_PHRASE, 0.7),
    ("99_speed_0.8x.wav", SPEED_TEST_PHRASE, 0.8),
    ("100_speed_1.0x.wav", SPEED_TEST_PHRASE, 1.0),
    ("101_speed_1.2x.wav", SPEED_TEST_PHRASE, 1.2),
    ("102_speed_1.5x.wav", SPEED_TEST_PHRASE, 1.5),
    ("103_speed_1.8x.wav", SPEED_TEST_PHRASE, 1.8),
    ("104_speed_2.0x.wav", SPEED_TEST_PHRASE, 2.0),
    ("105_very_slow.wav",
     "esta frase está sendo falada bem devagar para testar", 0.5),
    ("106_very_fast.wav",
     "esta frase está sendo falada muito rápido para testar", 2.0),
    ("107_question_slow.wav", "você entendeu o que eu disse?", 0.7),
    ("108_question_fast.wav", "você entendeu o que eu disse?", 1.5),
    ("109_exclaim_slow.wav", "isso é incrível!", 0.7),
    ("110_exclaim_fast.wav", "isso é incrível!", 1.5),
    ("111_long_slow.wav", LONG_PHRASE, 0.6),
    ("112_long_normal.wav", LONG_PHRASE, 1.0),
    ("113_long_fast.wav", LONG_PHRASE, 1.5),
    ("114_numbers_slow.wav", "são 2500 reais e 50 centavos", 0.7),
    ("115_numbers_fast.wav", "são 2500 reais e 50 centavos", 1.5),
    # Section 14: dialogues
    ("116_dialogue_greeting.wav",
     "olá, tudo bem? tudo ótimo, e você? também estou bem, obrigado!", 1.0),
    ("117_dialogue_shopping.wav",
     "quanto custa isso? são 50 reais. está caro! posso fazer por 40.", 1.0),
    ("118_dialogue_directions.wav",
     "onde fica o banco? vira à direita, depois segue em frente. "
     "obrigado!", 1.0),
    ("119_dialogue_slow.wav", "oi, como vai? bem, e você? também bem!", 0.7),
    ("120_dialogue_fast.wav", "oi, como vai? bem, e você? também bem!", 1.5),
]

assert len(CORPUS) == 120
