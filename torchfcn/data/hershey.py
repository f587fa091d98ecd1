"""OpenCV's ``FONT_HERSHEY_PLAIN`` as cv2 5.0 draws it, for
``torchfcn.data.raster.put_text``.

Generated by ``tests/hershey_probe.py`` from ``cv.putText``; do not
edit.  cv2 5.0 draws this font as anti-aliased coverage masks, not
as Hershey strokes: ``FONTS[(scale, thickness)]`` holds, for each
of the 95 printable ASCII characters (32 to 126), ``(advance, x0,
y0, w, h)`` in pixels, the mask's top-left corner taken from the
pen at the text origin's baseline, and the masks themselves, row
major and one after another, zlib-compressed and base64-encoded.
"""

from __future__ import annotations

import base64
import functools
import zlib
from typing import List, Tuple

import numpy as np

FONTS = {
    (2.0, 2): (
        (
            (8, 0, 0, 0, 0),  # ' '
            (9, 1, -23, 8, 23),  # '!'
            (15, 1, -23, 14, 10),  # '"'
            (21, 1, -22, 20, 21),  # '#'
            (22, 0, -26, 22, 30),  # '$'
            (26, 1, -23, 25, 24),  # '%'
            (24, 1, -23, 23, 24),  # '&'
            (8, 1, -23, 6, 10),  # "'"
            (21, 5, -27, 12, 31),  # '('
            (21, 5, -27, 12, 31),  # ')'
            (14, 1, -24, 13, 13),  # '*'
            (19, 0, -19, 19, 18),  # '+'
            (9, 0, -7, 9, 10),  # ','
            (15, 1, -13, 13, 7),  # '-'
            (9, 1, -7, 8, 7),  # '.'
            (17, 0, -26, 18, 29),  # '/'
            (21, 1, -23, 20, 24),  # '0'
            (21, 1, -23, 20, 23),  # '1'
            (21, 1, -23, 20, 23),  # '2'
            (21, 0, -23, 21, 24),  # '3'
            (21, 0, -23, 22, 23),  # '4'
            (21, 1, -23, 20, 24),  # '5'
            (21, 1, -23, 20, 24),  # '6'
            (21, 2, -23, 18, 23),  # '7'
            (21, 1, -23, 20, 24),  # '8'
            (21, 1, -23, 20, 23),  # '9'
            (9, 1, -18, 8, 18),  # ':'
            (10, 0, -18, 9, 21),  # ';'
            (16, 0, -21, 16, 22),  # '<'
            (18, 1, -17, 16, 14),  # '='
            (16, 1, -21, 16, 22),  # '>'
            (20, 0, -23, 20, 23),  # '?'
            (27, 1, -22, 26, 27),  # '@'
            (23, 0, -23, 24, 23),  # 'A'
            (23, 1, -23, 21, 23),  # 'B'
            (23, 1, -23, 22, 24),  # 'C'
            (23, 1, -23, 22, 23),  # 'D'
            (20, 1, -23, 19, 23),  # 'E'
            (20, 1, -23, 19, 23),  # 'F'
            (23, 1, -23, 22, 24),  # 'G'
            (24, 1, -23, 22, 23),  # 'H'
            (11, 1, -23, 9, 23),  # 'I'
            (22, 0, -23, 21, 24),  # 'J'
            (22, 1, -23, 21, 23),  # 'K'
            (19, 1, -23, 19, 23),  # 'L'
            (26, 1, -23, 24, 23),  # 'M'
            (23, 1, -23, 21, 23),  # 'N'
            (23, 1, -23, 22, 24),  # 'O'
            (22, 1, -23, 21, 23),  # 'P'
            (23, 1, -23, 22, 26),  # 'Q'
            (22, 1, -23, 21, 23),  # 'R'
            (21, 0, -23, 21, 24),  # 'S'
            (20, 0, -23, 21, 23),  # 'T'
            (23, 1, -23, 21, 24),  # 'U'
            (22, 0, -23, 23, 23),  # 'V'
            (27, 0, -23, 27, 23),  # 'W'
            (22, 0, -23, 23, 23),  # 'X'
            (22, 0, -23, 22, 23),  # 'Y'
            (21, 1, -23, 20, 23),  # 'Z'
            (13, 1, -25, 12, 31),  # '['
            (17, 0, -26, 18, 29),  # '\\'
            (13, 0, -25, 12, 31),  # ']'
            (15, 1, -25, 14, 7),  # '^'
            (23, 1, -3, 22, 6),  # '_'
            (13, 1, -25, 11, 6),  # '`'
            (19, 0, -17, 18, 18),  # 'a'
            (20, 1, -23, 19, 24),  # 'b'
            (19, 1, -17, 18, 18),  # 'c'
            (20, 1, -23, 19, 24),  # 'd'
            (19, 1, -17, 18, 18),  # 'e'
            (14, 0, -24, 15, 24),  # 'f'
            (20, 1, -17, 19, 25),  # 'g'
            (21, 1, -23, 19, 23),  # 'h'
            (9, 1, -24, 8, 24),  # 'i'
            (10, -2, -24, 11, 31),  # 'j'
            (19, 1, -23, 19, 23),  # 'k'
            (9, 1, -23, 8, 23),  # 'l'
            (29, 1, -17, 28, 17),  # 'm'
            (21, 1, -17, 19, 17),  # 'n'
            (20, 1, -17, 18, 18),  # 'o'
            (20, 1, -17, 19, 24),  # 'p'
            (20, 1, -17, 19, 24),  # 'q'
            (15, 1, -17, 15, 17),  # 'r'
            (18, 0, -17, 18, 18),  # 's'
            (16, 0, -23, 16, 23),  # 't'
            (21, 1, -17, 19, 18),  # 'u'
            (19, 0, -17, 20, 17),  # 'v'
            (27, 0, -17, 27, 17),  # 'w'
            (19, 0, -17, 20, 17),  # 'x'
            (19, 0, -17, 20, 24),  # 'y'
            (18, 1, -17, 17, 17),  # 'z'
            (14, 0, -25, 14, 31),  # '{'
            (8, 1, -29, 7, 36),  # '|'
            (14, 0, -25, 15, 31),  # '}'
            (17, 1, -13, 15, 7),  # '~'
        ),
        (
            "eNrtfXeATUff/9y2vbCs1VndYqNbPSwSvURnlURbRIloWYKoEQSRIBISJFEWEdFZXRC9"
            "t2jRy9pii71773mnfGfOzDk37yPPk6f8nt87f+yd+dy758yZmW//zhzUYyQu7VE5jRR3"
            "nqr0Uyv8z/osnE0+0oNQ/vK45EHWzgNxaYtqse9LNmKfkX/0Gf6cfDwMGf8LLnNRhT34"
            "IyHiIgFfoL70N/0SyN+rqDlttVxO/iagSNqqOI38/RaF0FauQeTvFIRe4I801Jq0+iN0"
            "CX9cRlVIqxlCO/DHTpTjJR6dogjNx615CJXv0KEKQiigVYeW/ogVu91uwR82u90KCPoA"
            "//g4QjUz8NWLArYHY+cQGk2uXhCwh7j+I0LfkJEh/9x01qy55PvTs2bdwR9Js2aEo5Oa"
            "sXyIzpiwiR6x3SZsMPKPiLiGK2cjIpYRoGZEKdJ7azquf4/QBvyRCL0rzC6CLuCPIxTo"
            "1+8TOoz9+mWSJ+zXtwhaZrrFCvS9CVvjEfvKhH2DcrfpRCpb2rQ5jz8etGnTJje+c2mC"
            "jUDoBv7YBd2j09wSeZGF9TlgFXbu2fOVL3Ks27Nna0kkl7Ir16xZXgQZynhyjaFGdAJB"
            "h6uYX/N9BF2VX8Jyr0iHfjs3tXUA2PSh/EDbfClYJl19zh0Eth0zPv6X5BGg/mLvRTer"
            "pfgh1INVr3gjVPUJq7dCaASr/URuUbBbT1y6B+EfwBU2t8ojddb6VNzm+ldd83J4pXx/"
            "97kp3uxpV6kdO5yPwpaxLgW+W4ZdJP8765IleJq4qVf9UfHQXe0XZTx9xsDIBfk8cOPi"
            "3BxM4LCXFM0KRtfY92c7lq3U6yCr70VotmnJaKMQqpxhBJ8Uwxern6yCv5Wit658T3m0"
            "MOiRrd6sq3DPia8pfZ1JwLhXWSUIDSZodyNqrVitWqRFb+fp+/HcwWX0druRI4cRftI/"
            "hY7Jp/yn75JmB4Si+bjD/WqQYVqFKxsJyzqE/9yheMgt0g7ENTzb7lB0nbBeMnE/E0YX"
            "SX7iIgwTbcVtwsjoLLxN/xevthSENuF2DTx0Tvy5jN0MD26WDZE5KIfC7hM25se+IFBc"
            "V8wKUhw2wmpS+RMN4YO7HE0mH134c1rWMfxc0BvkiRbqI2B56+fLN3a+61WQLJcTPihP"
            "nXZVAqURdJCHfF4sdCn5v5Q4u/iCrAh3W/sBuOMMjrch1DMHdSUgWfruAgwvRgTJYQda"
            "TDiKbaPonc8J8kM8WNvwZ3VKWmPoFwtxzdUUOHglRETHBILTK08ltS24EoVGsbWIyqbi"
            "yh4b79u0wJ2MWP0JQ3vICCmaD1BaDoS+xZ/ZDaHbS+ALvIT8LuPvh/DnsQ+6i/tx4g3k"
            "oeQs7as3Credsvnb2Ep25Rehh+G6j6pLaIlrggxeNNfh6xJ5OAsIDkrbLzddoJ99ODyc"
            "NgciRB5PW8/hiRSuhRBZedo6Dr/JOJN9OF3Q73HY/xbF79O/jwuKnryu8xtnQ4mc9nL0"
            "TrSO5tvB0RM5cXN0QkLC7jdQ/gfiEtl4UMvQK3az7pSeMbsTG/bUXC0ZMPsUu+V4QgXa"
            "ZDSFNlei3JKQvRWIfmRqBx7ds4KDNkZsyWtb8ArIc0PiiKDpHBw+8mdg7Fo7wnaemTha"
            "5psYH5BlwtPJENSRuNfJNDZ3dQjnXHAgkfYgoQmqdZfi+2Fg8jeqV8xblnpUh2K6E9OZ"
            "mK7EdCSmGzGdiOlCoAOB7sNZewVYYc0XHX+pjaUcdAZ9sDm4mmMz6+EcYBNQrwfVB00Y"
            "p9G0M528EIqg/5dMOBX6mq8nXC6TqisnradqTIHCJVgISwT66zhab6Lp4rw3rb9D63G0"
            "3kliTTG0/hatx9J6FJcluBTSQD0kZEf11p/Zo9Khf8aY8yH6owq03lcXw8iHyf8etDEO"
            "RF9vPPy5XsDDj8dfxGbr44OaJOp1VOIcXYHAFcPbTfmxTmBZoVmiNVrqvtmVWH0X+WVG"
            "D72uaXPtep1qRYNBBmYQiR8QyxYG5VqoPh31xADaWCyNXX1aX80ok5LAIXZDSha3WH0j"
            "5QasYyvoPzBBuoDW2UKhC0prIfi0pr0uMbmS8ECkMIlCCfiZrhtrZ2k1nP5kK613p3Uq"
            "OHyu0HoNMk6f8AUf8t5loR6BsNEuWcWYJDcS43OlrBi3TVT3QD3XftA0TF/h3m8PHhwb"
            "Co2a5HeMGbds6EPUuSqlBliQ3wv3V7/iQYzL0Oqh9jplfoYkDeqe9VeJiIMDy3Sli9k1"
            "rhzWbd98DvyNMEOiEaafJq0QLKnwf33XD8uMRrQ387PqBj9OyAf9wQzfR1IokH+lSpXC"
            "VKlASDvVX4GIhaPl+ydAJwys6mlhi4l9NfAEZRuhemjIUlKSqLpNap94/7N7z8qipKSk"
            "k1yNR5U/iIuLG+GPAlOB0GvTz9MIvU0r74JemBECtPAd/ie6IjGX9iJUcx3PT0mutNlj"
            "BgxoSZQCR6uuvHQIaCs9+PgYqTHzjxsN3HojFoUV46UQyvU+7nJcK6qJYJ3NPp79yPFH"
            "n22osn1aXkaoQFRUlGI5vUkEpitYQvYZtfkKmlHp/YLKcUnmBKWohgGiepSWLVlkFqpY"
            "/Cj95HV63cYSQpnFFanD+bOMFhxVy1/kkDRHyvMWSz9hdPqagVS0AxLAJFJnCfmMyi0v"
            "HQignPUj6ScDKB0XlBCqL8RLQF227CXkBwJckB6JmUCDpJ9QKZISpAP2O5pk9FJtl4r+"
            "chJCeekeWdmjj/SWhORfs3HjxjEWozbpX6//p1vXT42pKqSOpdtdvuKO1WBQwQOy3biU"
            "kI1tn0rJU4XolVSt+iiYKzZn70PlV9SUKz4WH/7DoKmsshOhhvy/m4CGN1rn7VrcL+yz"
            "NyrozNoORgA4TbpgXWz1Ilb/lOl0Wievh1r9L1h9Hse6YM2CY8CrYw5i6gJtfBY87Oda"
            "cgC3mKes4D2Yz1wkRCmO5VhZUCKwzVSRY21iwb5MtNrOG9neIsxxDBrfzSBdg4DiovLT"
            "0lXSAU/AhKDAj89QdTDx6CCbbHoWjq4Vapjh8PeI86+vQ4LaJWkGanPM5oymlWAOB8Vt"
            "ORb9SDNglnEyT2dYO+UpGFbgsRlDjQm32Rqv3uNDzTnWulDFrMNqMtNM7h831/612NDN"
            "pNxm2HFcXV8OPTSJugnokQcP3atim43Qy3ZM2+w0cdWpQwsH1hEM2tL5Fv9NFjARH8UP"
            "uMyHYEsNDh6hxUqlPEJADFn7fhPelkAno9VayAoksw814i49MIs17QbKO/NTXKYVQsyk"
            "pt4AvdSH672jQ2+kgu9GOKdQdyAJpzDzbBP5qhTGYxjXd7NHcqgBZy2J3F62juer8mIJ"
            "zkW/4w96hhOILV48/C90VjfHFx9rdjkN/dmMDdv6itgMtxHKwApejZFqGRTAxYdcenEd"
            "Qy6xrwwOwOAqNy+wkCpIs1KDcagnkoCyf8jm+0y4jhUHb0J8gDR7KeBcrGBUFdi/jxDS"
            "RPZof8tZ1XHVDcxKx9WrV685Cz4Ad26ZBPMBv2qjMLbPwX4PSjiBy/FP6D1Pw618wAm7"
            "OqrAm9zN8gFfm7I0q4yqphnBH0h3DDO3mCrXjWTd93Frvt667v2ddDz76obJiprpU+aN"
            "Sr5mF07Z98msv19MATvAo6+UweLw5LpThVgHohMyukDzgEpWyjrzRWXUm06K+7mKfsaG"
            "+KCCsoue8FJQdtHUUkhG2UWxuFbQz8QgS+gbjPe826NHD7Yub33zzfxc8zQPpfvnntAe"
            "fwbt6zKDadWR3cELWz4bHA5ZvKI006j/Mbqfjid4kv3eUQi+JcFGqbd3ErN4uaFPwVxf"
            "NWBXPGDM5SAo/iLueU4KXVD6xRT4XQrGPHXLay3ZdXn//B5M7+3D3E1wg8uNhb4tldGS"
            "E1NofZifgARL2w9KkPbQC/XeSMpCzO9bZDKwmtwFiBkNLvY6Kcy5/DFoacAa+xNSA97R"
            "cRbcIrZoNfjX7Jw1THN6CFluGiAXtl1KnlV9bVRR9pfDVk9qQb96bIfe3poj0WtgpSZd"
            "36pT3KBOh8ZSupaYJwoED8UY86Oe8tGh/gxKLaVDFTM0o6kVBMO5TLoYuB4u+htME6JT"
            "zuvMpWukFDTJmE6tC4cqcB7VMS9J7XExMObkct5/ENSOjJvAWVEzkMur7ZjqQWJOA821"
            "PnWksPp+WFDUIAMP4V6YDerYA4p/HzRv19RqUXPgHmWqmeb3GguoKspSJ6wXjVFcDc+Z"
            "O7nJU8mjGwEjU2TEyvNY6GWdWNhb0Zx9q9cSnLuSQV6/X+KIKRBqEt9rXgUx0ra2INfr"
            "UBqCrzhatfsUG/6gcYnUBE+5ru2vZ8gIAZRkrC8pyKjhztQjVoz7vRThADQJxKoeImWR"
            "PncF1cbXtG0CsF03PgBIo5P6KB9lSFcBwJK4rUc0flKCYYgzP/feAMWV0X/h2j07vp/X"
            "QcSRAuKFBM/8kA1ZkdPyUK8mDLekQXk/aiUmiKFU4R7g1B6h4R+5QZkIcuqUvZZWdyMv"
            "Rmdv6wJ5HZ+l01gziGJzOhahd4AWj5xn05FciscedUbaFJkU9WRiAA4xqCapjVFl/j8X"
            "uEGQHgDW5J4whF4Djb452LaUvfYE7sqmyRWiS2Ft1RquMWE+AWpyL84ctoyZDEzYFRZk"
            "UjsTMLMxBMB/Ikut5l5Z65oGCmLjbbcZpT7+Vg52eZVo3LhSIVn0BtXpN297/Ix36gmn"
            "jH2YiPje6MYuV1UhsNNkSEMfqH055y9IQi/LuU9CS9t3jmsGRcAncRaP3xugIr4FCmQH"
            "KZo+DZhypMgx0LSFqyWDBxZw36EgWepb/UbADFaqwO+WzP0BJ60sbUQurxtj98z6QrbY"
            "JxJ0D3TmnB9s5ta2q5EUN3xoCJoi4Vg57EBGMk6UnHWVmAR0S+p3IDz0PLNYOy55Au3M"
            "NLsoJKdPv/dx6cSlQeEO7LOU8RM4RalC2w7issaB/lYpXxOXcPAeOUP/6Lr8sxI1P+9h"
            "ZlGPdGh4foTu8AdiJvni/7UyhXRrf2P0SqXk6Li4uNG5kJXdojnEOB57gd71CUSq3KXB"
            "qNmH/2knZ+zE15CIRZEXWSofUwfLgAHtvY03iVpglU2E6dmaZEJVIXEm0XZMoouNtyPB"
            "Mcba9riXECSm4i+C560kER5tG8n1iPUkN6bYIb70qIPCGwxx92LmkY0Af8KbXKzAYr/O"
            "o7t9gFG4l4ALtwzIA+1+O1hAH0BvtPg8am+1iyAGHR855f4TNnBBbSOfmdlKG6FaV9U2"
            "8puf5KcOKJZAFptULCjsiaJUlK6qkmSLv9X2/+mgVDbnQX+y5HmQLZUnJf/s/QO2HpPK"
            "zryBn5dTrl9VyxxlU9pYgS6ptrW0wRaljaUeZxWFgaslcz/PCFCdtZ8hk6os9yk+A4lv"
            "HcTVy7UhDCnE3S3HDboxhA1Ri9/hLlRFCOV+nZT2NE+Dc74EkopXcBNn60MIcfjxLw8z"
            "NbsKaAejbfLznCwvP1/WJIf8/OeloDgqljnTx7hkzKV0uzHLEr6b2L26GLdSG8WcHGCB"
            "CctM2R3sHIHM3nQnvnNTo9W6jyX3UE14P6i8L73tKSI9gZsCYaEuEUcHb9wDTG51camG"
            "e20Fg00KnFjAlZ6iOzS4Wza7tf6zaXCDd6XwBCyD2dIgANEelEYIVJZsOTSTY8YcUtqr"
            "o+qDiyoBSlP2nVFTxprz0MBfhJWi6kValIEGo4d9vWflpB6186p4+1v6rFyQslcKbFBn"
            "bBXXqd8EJ8zDhF8uMadLalX6RV6ySh9Nb1eY5ZLFEY57ijy+hUzSDYkeox6A+tmPqCmE"
            "xIo0LWFB/rkDUSHM8NPxrUi8pDiWjkRcX2mdqTnrUs0zhjp2TyNUgelQLvrwxfHfL6gq"
            "9CGEqsSwYCF0imbGvIby4v9M/7zlSif7ZgWeQp8vcT2IhvCWQjQKf0PMtnzE9WylqmY3"
            "yEDrzfTcAuQbC1U3akCoH74JJd84qIrQBZIVxlM3Q7bfF5SNEw/GUR9Ukgz5+co1npJk"
            "wUHU0LCSPJenxyX9eCgqhFvTEeJhVf7d2VDqh8S2iHUaxZw9R9LB2MIjMSTrqfGsXetm"
            "YYYQ3GJgh/zCfZJeQcn3K1ykiJ1n/T4boxviDS7ygGAozQ16NHdom0oRtZuP3kNumMK0"
            "h3ImDfpeRSGTFEU/dX4BifeMOgZfJp0alcPAcgJL1G7XMjLYxIrsHaj5+l6EAR/OZXxu"
            "Fb/Abz1IgSsrkQSkZOfBIMuuTZsUwBon4Y2kZ7sk4cyg/y5Tyi2hBjlbqg1/kvJnSOnE"
            "3Bc2NsH3barduBgFZyqxrtxZvPmT4ksZyFIZ7HylJIP1z1Scr0gmErtQRzb+bPQfX8WF"
            "qSgbkWQAyP6IXCK7yeygr+rBOUkyuT71gLuLIhuzZpIWswKiciw3277g88+cLOe5O5FH"
            "DWn2IUmQp8qlSw+/V6GKbXYL1Ex3crxTKyes70ylGw92kfVpM/buxVseQM09wAOoneDg"
            "s7fffnssDI0rJ4A0uzUQLK7WMojAUdRTBpvARUsBmHngwAHudvzJYr77sRBzl5x1PHU+"
            "rT0H3ampqVzzdRWX7m5vA9rIe0o/QXbvV8B3QW+VwSpAYgsAdF66dEk4LNt6GLqsnGbw"
            "abS586fD1ZBS+qnv4trqGq4jssecHfGfDGwoGQ3he8REX+3PFZvGT5W5p8lollGGRJ4H"
            "xYW/WC7X8UjzmXDuv83hnqgB1GZjHlw7i7uWBgO90GXH8iq133mUB/LtDjwi5ZR9FY+V"
            "KmWtR3S9R3SdR3SNRxRs71msVa0TKXUhUVS7wuxPZoS8tHM5Q4kE0hWOoFLArK99WLHd"
            "D3qeqIfQYjRCNVKNIM3+KHfVEKVic5dDvsizydw/Yu218ADVKzLPD1U8ZchSqElUPt2H"
            "KEj+vWaSqifT/IMt05jkMa6y+1GeUC2zlyeUMn+OiogkXpmhSKeIgI5r3Hzji0I8e8D3"
            "pKLdYLmqqC8sJBVF8EhWFYWx9lVR8FJ7qShb9m6LguYDh4l6N0iCOKagOcC8/Z6jiYMH"
            "D13Eo+2dPY3ZXYcH1OWJ17qHeRj1c/X01CT6o5ubpnWNtBtmHspAXwOrJ50y3733n4JE"
            "PMqdWsNm9CKLDr8a9PwclLNdzM8f//dCyzi0ryOUDqF/rl9HB/MyML95JBaboeWvBply"
            "AlzDTZPWAZkmzR1mvlaRvxNy5gLo3Ju8RPLH3m8eCQ/Qr2WgFPWwaHuYobi/FxolaG0a"
            "lAl5/1xX/xKITZp7jkn79orsMXt7/Mf9GkrJfWUPc/+WljSNO4TaKiG3NBpCtk4xZpJ8"
            "ICnuUumJvHn+Xvahs04e1hAe7lnYcC0DksSV5324B42aVDhJtNmrZ4rCXr3v1P5LMjcg"
            "CkqELHP17Ir6kszVM0A6xHtEV+voIR1doTuYXxsyBFLo2kIc6g4TfaApVesi+ckRDxLm"
            "LgJayr3ZNaOGAZs/L0S8Omao/GMjeJRI0qIGCrzILKSAdXKcZlEukTo5L4H4CLPOrhwV"
            "qQ5e/kavSemkjIjBfZF/OGn08wI6ZvoEj323UCUQREc7/FvQZz1p2aGiavlnoxnbaLn1"
            "7xyHV0KBd28ATzddiymRMPNtONPODuJPm/v/oQo82zUHZmAGcTSShCx+NE1fSeQh9yry"
            "z4DfeQJ9a3BGFJUqReFESfqPA61g11bokEWc+BkTZZYVBkzaWVS3IdMsgWAhnW4cOfM5"
            "T2tBh03j0QkbU4bIq3aEuEPaqObaCubZaC85nrJFeoD1rQNU932wfWYdxWgIqxkdZmRg"
            "1I/k14vWh/jDkt4u2VxadUlA9gLsa0lqFoEY7m+BOmiFpIjsOpJ85ZJuuiR0I8AkP+ml"
            "g79AaDqjnCSeuegc7sGK2W01g88LITP4M/IAskiwEXyaTwZdygUAPASmodZXViNKwepI"
            "KSbrFjzdZr9VAi18A+T7shZSEBZIRnlZNenOY8sOWV/h6a+TZY0l9xE3RBbYFMshTpjg"
            "FLP+4/w/6I8h9zpeZnlwRxX+u3V1k3Vw249NWivduLe0IUATmDndjctyEdK4GcoVmDyM"
            "Zbltst9Bz/ETuJPFyCq7DDjZwIFvyreL6LhGQkadNTN+zRv53fGAY21+ouYJT66e7hHX"
            "pCxejjt1M0bBl/FLpH2j4BMh5UObNEXFA1nuxD1/Aw7ZOb2REbeRuTlhNeGo1LwlczFx"
            "m3AofzHOlkhWO4F3yWJeiWYiC5WkOlPj319ZJKHsijFw5eQC+l5ZrZ9NGNMeQK2lJ/B2"
            "gAeQhAjNoLOSB1A7ZvMAau96ApOjPIDaERVUHPIcnLTVAzixULIHkAbdTKBltwcQhad6"
            "ALk/WAWt+z2AqGS6B5CfCNKPzTJsErGtIWs9HYS3vVzMnB1fD6ol7wwN381JJftiC7FX"
            "TbZ/XLC34u2XKoP5xlumYl2hwCTPM+ue7OQHCmQX59mI2gLMkFpn8fQjiEnftEhJ/JvR"
            "XFZh2e9g0F3nNucEOV7/gtuc46R8Zi2Le3THsggx3JofQvGBdKwBpgswAsdT9DVwW3I/"
            "Lwtcg5M6ibuif6P9nc9TGMH1qBEjzv6IG8zFgCPemVIl9hc9zmPKONMe+yFUMdGI0ih6"
            "yYuGlFA2GcGynzd1JHfc295ZdIhw7ZdnVo4uoPp5izQp70BmP+/I/nVyeHLzar9vbezJ"
            "n5tNdg2a5c+6AE/+yskCPHTwIH++p9y7qtkR8ue73CpLIHI8N8Q8CAgJU1o3GeTxnrpC"
            "SH322W7QcLM9eL60NR76eTfCDO7IY3rMxAlWaUDily6dF9sgr6rxKftn/2UgyP67AeZ8"
            "E3uFHnN3LBkYJaczldzHJV72eZFn2VA+jMIJZ4/EGvYlfumQNHe9LMGTc0mQPPdgZxUS"
            "oZ15eM10dHJuNQx4rkXajbYOjiGgsVV+hoN2nhuPoylaGxYQHCBBlF3dXkqhh7EIvR7I"
            "OIPvPmB7xipBlIGnYY6UToDAxA1KMDskoRnPjIHNBRdk5Wc3z9nVSBDMG9b2J6gsWBc3"
            "J1UefEy48nnX5DUXhHueZERpUmVZQ2gH4uo5d6iEWBtmuN+XhyUX4Q3dn2gp+madEpBx"
            "8o26LIJY7MFpzBXIlQeXQJk9vNMw3O6JPWQtDffEHl4usHtiDzM9hoNFRDXz4MFDqcI5"
            "KblQAsHxleFQIifQk9dkMChNZSQE9ANu/cgq3YgP1kpPHCvGA/iVzQxO98AFD0gDkjJn"
            "DhN97mo6eEfIy70KaLsidCWp80ADF+wy6LjFDUX52QdCBM5fBn3u89iZ7HzqyEQ7RPu9"
            "Kvaau/OHSV0r6UsgeLWQ8/t4ulOkvCLdP9B009ZpHgKQvxrHabyeCPhsF8+KumXh6s4W"
            "PIxtwXAvg75kFZrWWrYH8S52tPNUHee3jaQUlnzC/+06N791Dk9HUWQfHUoZTN6DBgFA"
            "tR+vLw0Rcmb0lBi6PVNZDXxjfNMJP/PNT0uV85cgMe5WiVQS1cpYQokFDvxJ8gECT2hW"
            "Mqr/Vb6+l5iX3YdwPIAST8XsvKch+HuwOE1Gk/dRvhwDSS7ew3fRvrtvb5klp9H5loxq"
            "Vl3fCDHY6KMb2dfxjgcfa5PBHsDWrw728wA2DRn7ES6wsyGL1D8aAckFIVyfk8v/ga8C"
            "2i8LpkL5fi+2LUmy50ZGloeMQ9me2wsJRxuls4+0I/+fgBU1adDKgZYaxvNqpC2Z8RZg"
            "CSQh1ApC/VMEFmT2jt7Tbgl20dOcjuODfK5rHqJ1pZ6o2PeUW5WXD9fInAqJ/ZZ2n+4i"
            "VkX2pdXjSihTH9awssg6zjmMutx5Oz+l9N48+YCfwML67Q4JcUK2BDvUgzHU42KDaXFp"
            "2yfh4qC0DZLTZTCXKcZqm2gaEbOMb+q5WS+8xVku2lzdE0HT72awKs2Ora6bWkxWJVI2"
            "arnHFS/oHuyGBlWxMO8euF2bcQuYdS8TeJ4P46HrHYwZb1VzfpIb6fl3SNoIxew1tzCi"
            "cstu82Oe9rkrB0WOkGApP7Skjv4mT6Nu5CmR4ukCfl2Ga4rFpeSYW75nU5rcXzwLWQF9"
            "lDNBehOoJ8rBLiAdw8iN2VzoGRi1xo15SXzzWqq00/U55DTxI111qzNUaJ4QV26AUOW4"
            "ceOqCfk4RuRa90e+5ELJ/ty6aI1oAjJdFK3oZ3sE/rjSWEvKgFW3FDJo1kC+lVhAV2yM"
            "vJK9T+nKO4stZ/FU0xYvwPQQhxZq/LCNbZIh0FkNG0ChuywregpOajRz21fPztfVEjez"
            "0G4I2V1C7MSFgKEwFNbrx4jtMCTUthHhe77jim8LfOKl59fGyscO0aNqeBSZH0KUW+ov"
            "7M7ReCL7Y8nkOQopTVCGkWF7wk4TakF+94LGixx0u/PIGG/J1Tyyj4XH3ZdQGDSF9CDu"
            "4XGT7cDhL7iXFwVAYuBFL2SBTcQnyKy2EPpkX+EXlFL0MhokcYcS0w+fKz7fq76G3SPs"
            "3uKsC+sB1ZoVZ0HpLq/7sqk0ScDtlOOTuF19ReHRH0gJLnoppyuaifrRwnb5ZOCfBDzG"
            "YKRAvoh6+O0zCDSBZErkuzGY3BvJU7HEEZpkCZeBS+ywoGKp4jI2iCemFpU2kG8UTI16"
            "B0TIqRvbwOL8njmhCoLzb2FlugKaiOQWmtjQ7ms9AkCUcyYy7pZjq+SiTT7L412eoUw3"
            "0BZnvohb3iiczcodH32bYW/9yAu8GCsx2rtErpaPmSlPg/nemA4yZ50Cwukk42g52bJ5"
            "ARtUmpkmUJPOCguQNwvXE1M1RAe3SVvwxI4Qt7xpqLcmO8+FkwecKdlqan5vTedXegHK"
            "WPzvRCOoTZ3NZWieYUYTo6l5G7WWaZtm5p2OV8VGmKBkq7UKhP9bcbNpoE6bx1QHKqE1"
            "7kPdrovRxTy1J4d6BhtZQsUF1IOfoFNfQI25q+xt/cyGZN37wTfFce68UaRa5+QHgp0W"
            "7jtvTqEPCquH0NHUOx4/XFHwgnlc+l0yYwNeFVtlgtLr5Th9D8rZPNL+hAavUI9k9W11"
            "6tQpB3sblktb6/6b6qfi4uIG2KRnr/UqY1VQiJeskigwP5QgZKmE17CyYac+5cbyUSJ+"
            "iUKpVnbcPJeDOyVcIqmAF8oFT8kI231dS+Y/NyRlmxVqC2XKm1RzZ+jxFXmvzi1Z3WSK"
            "vXKC2jEDZwSHsku2a3ye6pEXJGXAPZOPTwp3qeSG4GDh4zLCNKUasgZMT76W83bRe1SF"
            "kLc75UwDfUQvVL/9zWra+dRM/tFhOTdET0p3yTugvB8JJ5cSoH0ipQSigE83bty4xBYi"
            "qO9cWG195UT/Ub2MVEcRmPA2QV13Xf9X1a39MOExp2N01VcYH7leVKe+0ihIpz46/GXL"
            "lhV7OmsQU8IFSVHln0mSJZyzc3KMUD5i5j/6iGjLztZEv/39fUyLzX9xazctVj9ulXv5"
            "OVCX7eayxJrgyZYovudPoJ6v0N3D3ZbaUPVmuDQicaEQpiIdIfUa7IlWE32owDE9LOpL"
            "M+7cVN21vHf94cOHjIIiZ244l/bg8MrhwHaKrxF2z/1YcpGid+XODDKe96allQZDzzU8"
            "T3snWF32zm/jUl5sFd4IpFuhy8RVzyAYjJsd10o+lPsIva7mwNxHdbhCnsQCNPfBo3Bp"
            "WAmIzd9nFvlLrDp7MeXvPrOY3A1RLlAu73uBIE90iyuvNjprUQg/izB9Pe+PfcZV8h+7"
            "a0RnCCcJytGgtq7uF95BDmTfJL/uoLtRoRS7Vev/lVDJLw6nXFvbz6pDq2Cw9oXr+2N5"
            "ueptgrQ4M5TmBVDKW/law6BFxughPDBjYmJ0OxSO+JkGUJS+o3RujD4SEOObBVAfvdeD"
            "4POED3KA4VOX9+tZAuQxuINNXd1h6n1maYAecmuQnKJZlaqSq+zTSDTF9UtF1fsWLR3o"
            "V7Tr7L3Jt7fM6smh3sLC+40KCdsc+XaLkekozljkC0GVJPjMLAhno8wP9INckGEQPsCm"
            "WfET13G50pm9y+Ge1LH7gkh4+d3kdGKuBifWOr1HTMZlYglw2TcVG/mn52XUnPHNd1lc"
            "qhhSTbEkL6Vkz1wkHqAcUurMXnaSlu29jTSA/2KrvBxzR9fMazqGGNU7QMhCPuWYB2G9"
            "zJD3PwKFTt/x+MG28f461AbSN27s5VAN40EL3lbT+3u8m5oYrzcYDgeqF53CIXBXlNB3"
            "N3ifY0tV8vB4M//QXckv5X2F8xRxLpQ3O/HYFagfKuQ9U/ghKwAxe/Nsz8uH+Gr0Dks2"
            "dZWpQCrk4M4w9zp9vHrdpW7o1jnpKJ1hU5e7XpR62DzK13rqzudPz8S34spgjMi+u8pO"
            "yR4sDSrdR6Gec/RrIHIwI+6r/DXZal4EbsMMLx7wvAy22W2s6DDPkjuX6cVXzUxB9gmm"
            "TfYTWJT8djdeOgVPhVQDLGaKkDPWc/PzyvqgQOb5cPpbwfl7E7xNB5FwokDcmRjw0ZKp"
            "dYb5gu2xF6nykXa4rb74bcUa186n0kKp9mOX7kxIYNkPjhkwZI8ptxGh1idy+i5r5tEH"
            "96ye37A6unJlYtayl1+wI/AjVm+Atbxhw4a11T9ShmXhFKW52NAcpjSn2us0gH+PbtCg"
            "nrfYjK/ZlL35//ZmlReKe7vQ7N1Pbq8a7G1fiEdgw3wsELvzvHp2IJNWSjqcAKa3jP2c"
            "cQ2VbWfiAGVhwA5UKwrRDi1ik84BwMsUcU3nAHCmSrlbOgeAzf/l2K8zSQYO7Bkuv1wk"
            "jYQA06oAXr7nCz7ih1pWqGE6dThSPs+DQwWFOytbRHdCWEZs+ujFAkIob4PYfnVzcidd"
            "+YDWb+HyplXfExYyWiTi+DFWlsxDFs6vpoE3fBl/d4geyMa04acw1kd1qcY8Uk9vOc1P"
            "F8o3eunBx+6bP03ronIeh0G12lfFrFpNNKtDfy3U8suTybvGRurQJxAccbYTkKDQly3N"
            "elRmjhhzPJ5DM8u0BtqfEKNnJkHwaxu/IzE0Gc+9I3eVCYG7/xEQU61YPjJT3TaGJZzE"
            "5SvuZnQYP5kEeG5FVaJxKaofxLOcEO8MnoeZG+6W51/1WY3ylOtUO5lMHuE4jY+wYMbq"
            "P66e0aNweckTNTCeDz2CPNf6ZvoGIuo5YQJ8+39e1Z4lXNStgAl8eeoqMKCKIoT6xMqr"
            "md1gH732sCYNjGVfWjWGbLjxzpfPT6FkJTDKKDkbmajvr4aKfUMmYEM3HfI7xwNqAoJD"
            "Zw97CwgSan7PJ64Fx2CmVxWXdzE1xN1F4h2gdiMjtN1qgm7lNEHwDjYGuUHfGyw9EEjs"
            "jIo6ZAEn+JUA/bFDIXNshTQSjYBh9ZIGB4Tai9KMko8S/ruJ/s7Vm03aNxbguaH/aor8"
            "s5/sEa57UU6yvjmqMv1U4u6ZZLZqTf/12cZh+cUBE9tjGV9NqYZi2aD8lp8PlNiN8kTY"
            "eudCzPxdSpD+4++28u9OlI0AYX6qTGnG+h/x794Q6fHtBckVihEWIiTJVxHJ7nVieO4E"
            "z4WthNXM/6LvGCe+jfloLmr8P86FUBA9KOlpASYlRiPvvl+fT/zx3SJiSrOKg1PqaXlB"
            "PsJsuF/CPEmHzNBLH4AyRhXrcZNVawL0o54RMixG9x9CTtYigHoikU/z5X8ExMYyjXjP"
            "A6jjLJt6Pcv0mLXj4ZPdn/bmZyOOEIzdRc9W9lWOp10faNpmvw0FQtz5AESRs/N0EmkL"
            "IMT7gDqJiSuY3WDLLd0KZj6HpPu6W4PFnZ3M0XGbIIxTv2CW9ku8JGxMUp0bI/xPQCDT"
            "IAHsSv+ewN5rot/UPj+0oteV44+SiVQuLsXgrrFwbdDH26nP88Gu2bmkwwxr1xP76r4l"
            "y7AXKjtlV9KtzaO9xDK82hI03XMV+TJ8KfTE2/7mNTfdDGU4AHrRXrjgKsTwLFPhguuu"
            "8w/ugpsaw5/c5IKrbXbBxeiyZyh8HvEVLrgGvF+PuQtOy2Xq6nazC64kh/iLMjP66C7L"
            "ToSMs/aUVRybeRu95v2XO0nr0vX2srisEwTnwyXQoJ4VWrD/2Z21IwJtX5ApnUxOX4Qx"
            "PwPGY6DYBCGkQ7DZeAxuZmL/wbDl+1D1cB7/DgYyKq9nWgfDGrfqCRDBN4TrgieqBF/V"
            "U3jgYsG7eLqXOCkrGGTWBMyZYCEG8wSFywd5rklwmMmhEowGmyEbtzGfHeQQQh1+w/Pq"
            "Olpilg5h0qhL3EcKpPjp/hKIpWU8UE4ODSVT6ou4WEDVYpdsWGADkRDKtp6UA3HwQCUl"
            "7RWaWXmhmfVZvTJlyoSKta0uvIFqs+c/vSmxdV4KxsxJSHx85PtBXOd+S0zykzFU95wt"
            "exFW2E25b0P4yrpQpPz3brBUGHO/gDl4cXIidyhC8Eql9F1Tm4JHtoJ+jaTlrei9+sg7"
            "DZdSqPZh6f5fwWmqgzfxXrpFSMXG3W0xgece4nIsGvHEwRawTcd9nCXKa08dsPVZFBJP"
            "Hy5lVaUNp3cPm0rf6KNlXFitb7zyLhH9ekE9HpxjM1F4VwqgniEfsv4/0q4dvwHc/1vx"
            "Uh1m2EKQDK/OFU4qU/sTpX0T+dRvALZAxwYNGhT4B/pX0HD+s3i/A7z8YG/jiAiWl7Zf"
            "3D+bDuIMvUPUzxNxV22jfIfVNvIetHAPocNnBcutJiS7hFjLIdRCW1lwiv5TeLdm/2k6"
            "ZwefZ+y/DSIJvOBBjoVFR45og4mJhYzYwzlRIcgUi/UDl3nGkWwRHzpt5LOxqH22CUK9"
            "gVhckx6LXNDue/Gid15ozg5USWfizrd+RSkwUmsdHsk1LCvSMokM69febKPOdeqXbgic"
            "MWe6njLCVtoahJbRConZwK6XBjz944mDjwY9pZ05AFvyfbBD9Dzz1SgnJUz2Dk//JJYq"
            "2kfOymRpUL1Z/LsykpL32cvCjnjIy+Z8T9qs/FT4WbzEO/dmmc+xdktJKUVdmu7x4GWz"
            "8MBK2dk0Qp0AOWUFfyCrk2qG1X/YsJ6+r9Q+m9iYraP1dL6D3CfcmrnWveizp2DVkEXg"
            "yE7HL2HcWFS6Ec/6PYDnilJOqg/qyJkY65crDBS5eIQC6cheg08SxhgvkkDZr8t01Lh8"
            "oloc3QTB7jGCvwwpozjtDj3YgfXsIOlpop47PUg6J5cuPRFschdS8lC1zBzCAfyrITt+"
            "g8j3FTn1PEuuM/LiG4nLKccbaC/8RUD1qoEpkbeLvWHIxbP8LhJR7U8MKVDDiQA6TL15"
            "o4lHaw/l6t5fE5JYQZlXy3gyhW1QCFvrpzEVlWEx22kI9WC3+hg5mFl5wVdEaFz1mDB6"
            "SQPJuZlW8SBbk9KNmkmSbi8XJ4sE9FzkBPpf41g3ZDjLA/N4XTLlF1kSIlvLulPXUvgm"
            "v/clHnKDqU6VmSBO0UcR+TPDK6PSDj3zdgn3NMGdUkvzTScbLIIbn3Awrew0Pdp/Dn3k"
            "5AJlCSNfB/TTggzqmgj2v8999UwwrZWDJW500c8DuGWHnFKaHp/ARzAv7bKrEH/rbVqI"
            "yBIex2XOIn2P3jWLg84BvECX8aZ6rMs74dwDpoZs4WyL8k3arTT6ENf4SEsv7BGvJQ4X"
            "3Fl6i6848X++Pm98I7tLeumXBQLrm5FJkdXeMCWwiXdgSGlufBcAnDKvmTIEIXQ8S4ZY"
            "yn52uHknynrF+KGh1pc1FMybqNTSZvMaazdIJb6m9GJCUOW+UIGlZmCCCixC1lJlcXkN"
            "IklJsNmRv2gsqTrM0Va17bdTbfsnqO3A/Wo76JDa5tno2uNTtOwJO2WQvM3/NmB4P1my"
            "mG2/zlN+vALvTbB0vaMnmIaAFkRbFr50liubjEhOcx7mek9e3NxXcLvUKHn7wHvK0Y08"
            "wYitMXjfRqCL6Ydy4HQtazRg7I29uq4D41GJrPvsYIYXwD8ZxT6CwBso/Ils9dvGsH8c"
            "oWTW71N2DN3lQ0LjJG4/hWiqKTsw+KtFGMe4AScWg/vqYj+mm4q3KNJTPwIuySOIIlPk"
            "Fsq72Cm1sE46b9c9dUtWkNXr+z179iy2MK0jD/Phhf3XfrCNQXnsX8THx3+Mwi8lfDZA"
            "d4tQDSZrXm65iQmmjdLUkkvI5zRgScBUzopxJ0WcmKli2/XAGB1qJ1NZeLnEUrnU07nr"
            "q4cciTePMK79E2eJpZj29oVdPQZ8J3xfANSL5kCAQOodFHfCJaY0BrFL7Ssg23knAhX5"
            "K17wuEzNET6uZ14QakgX7kwkbAHG7L2iv+YRAsTfPkKoKp88sK4myjhPkof9aF2+C8Gd"
            "evTrDrpoyKGmmATO/OXur9/1pg/TcyY/ucd9cfOq69pz1cZPrvO/Na9U1+7PHzpzK7MN"
            "nL18B9KZ8mkyeVn81GrofwBjfkgz"
        ),
    ),
}


@functools.lru_cache(maxsize=None)
def glyphs(scale: float, thickness: int
           ) -> List[Tuple[int, int, int, np.ndarray]]:
    """(advance, x0, y0, coverage uint8 (h, w)) of each printable
    character at a recorded size; other sizes raise ValueError."""
    key = (float(scale), int(thickness))
    if key not in FONTS:
        raise ValueError(f"FONT_HERSHEY_PLAIN is recorded at (scale, "
                         f"thickness) {sorted(FONTS)}, not {key}")
    metrics, chunks = FONTS[key]
    data = zlib.decompress(base64.b64decode("".join(chunks)))
    out, pos = [], 0
    for adv, x0, y0, w, h in metrics:
        mask = np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)
        out.append((adv, x0, y0, mask))
        pos += w * h
    return out
